"""Op dispatch of the PyTorch port (counterpart of
``mxnet_tpu/ops/dispatch.py``), as far as it has meaning over torch's
autograd.

The reference's dispatch unwraps its arrays, runs a pure JAX function,
and under ``autograd.record()`` records a ``jax.vjp`` pullback on its own
``Tape`` of ``TapeNode``s, which its ``backward`` sweeps. In the port the
array is ``torch.Tensor`` and the tape is torch's autograd graph, so
``Tape``, ``TapeNode`` and ``backward`` have no counterpart here
(:func:`~mxnet_tpu_torch.autograd.backward` is the sweep). What stays:

- :func:`apply_op` calls a torch function on tensors, after the
  mixed-precision hook casts its inputs;
- ``amp_policy``: None until :func:`~mxnet_tpu_torch.amp.init` sets an
  :class:`~mxnet_tpu_torch.amp.AMPPolicy`, whose ``cast_inputs(name,
  arrays)`` returns the arrays to run the op on, as the reference's
  does; the named npx ops consult it too, and the captured graphs key
  on its ``version`` (:func:`amp_version`);
- :func:`is_recording` and :func:`is_training`, the port's autograd
  flags.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

from ..autograd import is_recording, is_training

__all__ = ["apply_op", "amp_policy", "amp_cast", "amp_version",
           "is_recording", "is_training"]

# set by amp.init(): an AMPPolicy whose cast_inputs(name, arrays) applies
# the mixed-precision cast rule here and in the named npx ops
amp_policy = None


def amp_cast(name, *arrays):
    """``arrays`` as the live AMP policy casts them for the op the
    reference dispatches as ``name`` (a list): the chokepoint of the
    named npx and np functions, which test ``amp_policy is not None``
    first, so that AMP off costs them one global read."""
    return amp_policy.cast_inputs(name, arrays)


def amp_version():
    """The live AMP policy's ``version``, None with AMP off: a part of
    every captured graph's key."""
    return None if amp_policy is None else amp_policy.version


def apply_op(fn: Callable, arrays: Sequence[Any],
             static: Optional[dict] = None, n_out: int = 1,
             name: Optional[str] = None):
    """Run ``fn(*arrays, **static)``: the reference's eager op call.
    ``arrays`` are the op's tensor inputs (``amp_policy`` casts them when
    it is set and the op is named), ``static`` its non-differentiable
    attributes; torch's autograd records the call. ``n_out`` > 1 returns
    the outputs as a tuple."""
    arrays = list(arrays)
    if amp_policy is not None and name is not None:
        arrays = list(amp_cast(name, *arrays))
    call = functools.partial(fn, **static) if static else fn
    out = call(*arrays)
    return tuple(out) if n_out > 1 else out

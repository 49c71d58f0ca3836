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
- ``amp_policy``: None until the port's ``amp`` (``ROADMAP.md`` §1 item
  9a) sets an object whose ``cast_inputs(name, arrays)`` returns the
  arrays to run the op on, as the reference's does;
- :func:`is_recording` and :func:`is_training`, the port's autograd
  flags.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

from ..autograd import is_recording, is_training

__all__ = ["apply_op", "amp_policy", "is_recording", "is_training"]

# set by the port's amp (ROADMAP.md §1 item 9a): an object whose
# cast_inputs(name, arrays) applies the mixed-precision cast rule here
amp_policy = None


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
        arrays = list(amp_policy.cast_inputs(name, arrays))
    call = functools.partial(fn, **static) if static else fn
    out = call(*arrays)
    return tuple(out) if n_out > 1 else out

"""Control-flow ops of the PyTorch port (counterpart of
``mxnet_tpu/numpy_extension/control_flow.py``): ``foreach``,
``while_loop`` and ``cond``, with the reference's results.

The reference lowers them to ``lax.scan``, ``lax.while_loop`` and
``lax.cond``, which also run inside ``jit``. Here they run eagerly and
inside a hybridized block's CUDA-graph capture, where no value can be
read on the host. So:

- ``foreach`` is a Python loop over axis 0 (a fixed count), differentiable
  through torch's autograd, as ``lax.scan`` is.
- ``while_loop`` reads its predicate on the host when it runs eagerly and
  stops there, as the reference's loop does. Inside a capture it runs
  ``max_iterations`` masked passes: a pass after the predicate turned
  false computes ``func`` and throws its results away
  (``torch.where``), so the outputs are the reference's either way. Its
  outputs are padded with zeros to ``max_iterations``. The reference's
  loop cannot be differentiated in reverse mode (``jax.vjp`` of
  ``lax.while_loop`` raises), so here a loop variable that requires a
  gradient raises :class:`MXNetError` while grad mode is on, and the
  outputs never carry a gradient (a tensor ``func`` closes over gets
  none, as it is a constant of the reference's trace).
- ``cond`` reads its predicate on the host when it runs eagerly and runs
  one branch, differentiable like ``lax.cond``. Inside a capture it runs
  both branches and selects with ``torch.where``; each branch takes its
  inputs through ``torch.where(pred, x, x.detach())`` (the else branch
  the other way round), so a NaN or infinity that the branch not taken
  produces in its backward stops at that select and never reaches the
  inputs' gradients. Tensors a branch closes over are not masked.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..base import MXNetError
from ..numpy import _capturing

__all__ = ["foreach", "while_loop", "cond"]


def _flatten(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _one_or_list(xs):
    return xs[0] if len(xs) == 1 else xs


def _pred(p) -> torch.Tensor:
    return torch.as_tensor(p).reshape(()).bool()


def foreach(body: Callable, data, init_states):
    """Scan ``body(item, states) -> (out, new_states)`` over axis 0 of
    ``data`` (one array or a list); returns (stacked outputs, final
    states), each one array where there is one."""
    data_list = _flatten(data)
    states = _flatten(init_states)
    outs = []
    for i in range(data_list[0].shape[0]):
        items = [d[i] for d in data_list]
        out, new = body(_one_or_list(items), _one_or_list(states))
        outs.append(_flatten(out))
        states = _flatten(new)
    stacked = [torch.stack(col) for col in zip(*outs)]
    return _one_or_list(stacked), _one_or_list(states)


def while_loop(cond: Callable, func: Callable, loop_vars,
               max_iterations: int):
    """Run ``func(*vars) -> (out, new_vars)`` while ``cond(*vars)`` holds,
    at most ``max_iterations`` times; returns (outputs stacked and padded
    with zeros to ``max_iterations``, final loop variables)."""
    vars_ = _flatten(loop_vars)
    if torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in vars_):
        raise MXNetError(
            "while_loop cannot be differentiated in reverse mode, as the "
            "reference's lax.while_loop; detach the loop variables or "
            "use foreach")
    capturing = _capturing()
    acc = None
    with torch.no_grad():
        active = None
        for i in range(max_iterations):
            c = _pred(cond(*vars_))
            if not capturing:
                if not bool(c):
                    break
                active = c
            else:
                active = c if active is None else active & c
            out, new = func(*vars_)
            out, new = _flatten(out), _flatten(new)
            if acc is None:
                acc = [torch.zeros((max_iterations,) + tuple(o.shape),
                                   dtype=o.dtype, device=o.device)
                       for o in out]
            for a, o in zip(acc, out):
                a[i] = torch.where(active, o, torch.zeros_like(o))
            vars_ = [torch.where(active, n, v) for n, v in zip(new, vars_)]
        if acc is None:             # no pass ran: the outputs' shapes
            out, _ = func(*vars_)
            acc = [torch.zeros((max_iterations,) + tuple(o.shape),
                               dtype=o.dtype, device=o.device)
                   for o in _flatten(out)]
    return _one_or_list(acc), _one_or_list(vars_)


def cond(pred: Callable, then_func: Callable, else_func: Callable, inputs):
    """``then_func(*inputs)`` where ``pred(*inputs)`` holds, else
    ``else_func(*inputs)``; one array, or a list where a branch returns
    several."""
    inputs = _flatten(inputs)
    p = _pred(pred(*inputs))
    if not _capturing():
        outs = _flatten((then_func if bool(p) else else_func)(*inputs))
        return _one_or_list(outs)

    def masked(take):
        return [torch.where(p if take else ~p, x, x.detach())
                if isinstance(x, torch.Tensor) and x.requires_grad else x
                for x in inputs]

    then_out = _flatten(then_func(*masked(True)))
    else_out = _flatten(else_func(*masked(False)))
    return _one_or_list([torch.where(p, a, b)
                         for a, b in zip(then_out, else_out)])

"""Automatic mixed precision of the PyTorch port (counterpart of
``mxnet_tpu/amp``).

A dtype policy (:class:`AMPPolicy`) sits at the one place the
reference's casts it: the named ops. Each npx op that carries a
reference dispatch name (``Convolution``, ``FullyConnected``,
``BatchNorm``, ``softmax_cross_entropy``, ...) hands its tensor inputs
to ``ops.dispatch.amp_policy`` when one is set: ops in
:data:`~.lists.TARGET_DTYPE_OPS` run with their float inputs in the
target dtype (bfloat16 by default), ops in :data:`~.lists.FP32_OPS` in
float32, every other op as it is. With AMP off the ops test one module
global. Parameters stay float32 and gradients reach them in float32
through the casts' backward. A hybridized block's captured graphs are
keyed on the policy's ``version``, so a graph captured under one policy
is never replayed under another.

Usage (the reference's API)::

    amp.init()                      # bfloat16 policy, process-wide
    amp.init_trainer(trainer)       # dynamic loss scaling on the trainer
    with amp.scale_loss(loss, trainer) as scaled:
        autograd.backward(scaled)
    trainer.step(batch)             # unscales, skips on overflow
"""
from __future__ import annotations

import contextlib
import itertools

import torch

from ..base import MXNetError
from ..ops import dispatch as _dispatch
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "disable", "is_enabled", "init_trainer", "scale_loss",
           "convert_hybrid_block", "unscale", "LossScaler", "AMPPolicy",
           "lists"]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}
_FLOATS = (torch.float32, torch.float16, torch.bfloat16)

_policy_counter = itertools.count()


def _target(target_dtype) -> torch.dtype:
    name = str(target_dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise MXNetError(
            f"AMP target must be float16/bfloat16, got {target_dtype}")
    return _DTYPES[name]


class AMPPolicy:
    """The cast rule the named ops apply. ``version`` is unique per
    policy: the graph caches key on it."""

    def __init__(self, target_dtype="bfloat16", target_ops=None,
                 fp32_ops=None):
        self.version = next(_policy_counter)
        self.target_dtype = _target(target_dtype)
        self.target_ops = set(target_ops or lists.TARGET_DTYPE_OPS)
        self.fp32_ops = set(fp32_ops or lists.FP32_OPS)

    def decide(self, name):
        """The dtype the op ``name`` runs its float inputs in, or None
        (cast nothing)."""
        if name in self.target_ops:
            return self.target_dtype
        if name in self.fp32_ops:
            return torch.float32
        return None

    def cast_inputs(self, name, vals):
        """``vals`` with each float tensor cast to :meth:`decide`'s dtype
        (None entries and other values pass through)."""
        want = self.decide(name)
        if want is None:
            return list(vals)
        return [v.to(want) if isinstance(v, torch.Tensor)
                and v.dtype in _FLOATS and v.dtype != want else v
                for v in vals]


def init(target_dtype="bfloat16", target_dtype_ops=None, fp32_ops=None):
    """Enable the AMP dtype policy process-wide."""
    _dispatch.amp_policy = AMPPolicy(target_dtype, target_dtype_ops,
                                     fp32_ops)


def disable():
    _dispatch.amp_policy = None


def is_enabled() -> bool:
    return _dispatch.amp_policy is not None


def _grads(trainer):
    for p in trainer._params:
        if p.initialized and p.grad_req != "null":
            w = p.data()
            if w.grad is not None:
                yield p, w


def init_trainer(trainer, init_scale=2.0 ** 16):
    """Attach dynamic loss scaling to a Trainer: each ``step`` (and
    ``update``) divides the gradients by the live loss scale, skips the
    update on overflow (the gradients are then cleared as after an
    update: dropped for ``grad_req="write"``, zeroed for "add") and
    adjusts the scale. A bfloat16 policy starts at scale 1.0 (bfloat16
    has float32's exponent range). Called again, it replaces the
    scaler."""
    policy = _dispatch.amp_policy
    if policy is not None and policy.target_dtype == torch.bfloat16:
        init_scale = 1.0
    scaler = LossScaler(init_scale=init_scale)
    scaler._already_unscaled = False
    if hasattr(trainer, "_amp_loss_scaler"):
        trainer._amp_loss_scaler = scaler
        return trainer
    trainer._amp_loss_scaler = scaler
    orig_step = trainer.step
    orig_update = trainer.update

    def _amp_apply(orig, batch_size, ignore_stale_grad):
        scaler = trainer._amp_loss_scaler
        overflow = scaler.has_overflow(trainer._params)
        if not overflow:
            eff = 1.0 if scaler._already_unscaled else scaler.loss_scale
            orig(batch_size * eff, ignore_stale_grad=ignore_stale_grad)
        else:
            for p, w in _grads(trainer):
                if p.grad_req == "write":
                    w.grad = None
                else:
                    w.grad.zero_()
        scaler._already_unscaled = False
        scaler.update_scale(overflow)

    def amp_step(batch_size, ignore_stale_grad=False):
        _amp_apply(orig_step, batch_size, ignore_stale_grad)

    def amp_update(batch_size, ignore_stale_grad=False):
        _amp_apply(orig_update, batch_size, ignore_stale_grad)

    trainer.step = amp_step
    trainer.update = amp_update
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Yield the loss times the live scale; the wrapped ``trainer.step``
    divides the gradients by it again."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) before scale_loss")
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the current gradients by the loss scale in place (for
    clipping between backward and step); the wrapped step then does not
    divide again, and the scale itself is untouched."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for _, w in _grads(trainer):
            w.grad.mul_(inv)
    scaler._already_unscaled = True


def convert_hybrid_block(block, target_dtype="bfloat16",
                         cast_params: bool = True):
    """Cast the block's float parameters to ``target_dtype`` and its
    float tensor inputs on the way in (a forward pre-hook, which runs on
    the hybridized path too)."""
    want = _target(target_dtype)
    if cast_params:
        block.cast(str(want).replace("torch.", ""))

    def _cast_inputs(blk, args):
        return tuple(a.to(want) if isinstance(a, torch.Tensor)
                     and a.dtype in _FLOATS else a for a in args)

    block.register_forward_pre_hook(_cast_inputs)
    return block

"""Trainer of the PyTorch port (counterpart of
``mxnet_tpu/gluon/trainer.py``): applies an optimizer to a set of
parameters after a backward.

``step(batch_size)`` sets ``rescale_grad = 1 / batch_size`` (times the
optimizer's own scale) and updates every parameter in place from its
``.grad``. Then it sets the ``.grad`` of every parameter whose
``grad_req`` is "write" to None: torch adds a backward's gradients to a
``.grad`` that holds a tensor, where the reference overwrites, so
clearing them makes the next backward write fresh gradients. After
``step``, such a ``.grad`` reads None; a second ``step`` with no
backward between raises. ``grad_req="add"`` gradients are kept (the
caller zeroes them with ``zero_grad``).

A step follows the reference's fused update (``trainer.py:316-371,
459-490``): every updated index's count advances first, then the
learning rate is read once, rounded to float32, and the gradients are
scaled by ``rescale_grad`` in float32. The per-index lr and wd
multipliers are fixed when that update is first built (again only when
the set of updated indices changes), so ``set_lr_mult``/``set_wd_mult``
after the first step do not reach it. Optimizers that are not
``fusable`` (SGLD, Nadam) take :meth:`Optimizer.update` per parameter
instead, with the live multipliers, as the reference's eager path does.
"""
from __future__ import annotations

import pickle
from typing import Dict, List

import numpy as onp
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..optimizer.optimizer import to_device, to_host
from .parameter import Parameter

__all__ = ["Trainer"]

# kvstore names that mean one process on one card: the all-reduce is the
# identity
_LOCAL_STORES = (None, "device", "local", "none", "null")


class Trainer:
    """``Trainer(params, optimizer, optimizer_params, kvstore,
    compression_params, update_on_kvstore)``: ``params`` is
    ``net.collect_params()`` (name -> Gluon
    :class:`~.parameter.Parameter`, deferred ones included: they are read
    at each step), a name -> ``nn.Parameter`` dict
    (``dict(net.named_parameters())``) or a list or tuple of Gluon
    Parameters (named by ``.name``); ``optimizer`` a registered name or an
    :class:`~mxnet_tpu_torch.optimizer.Optimizer`. As in the reference,
    the Trainer gives the optimizer the parameters' names (``idx2name``)
    and nothing else: a Parameter's ``lr_mult`` and ``wd_mult`` do not
    reach it, and per-parameter multipliers are set on the optimizer by
    name (``set_lr_mult``, ``set_wd_mult``).

    ``kvstore`` "device", "local", None, "none" or "null" is one process
    on one card (the all-reduce is the identity); a distributed store and
    any ``compression_params`` raise. ``update_on_kvstore`` is accepted:
    with no store, the update runs here."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            names, items = list(params), list(params.values())
        elif isinstance(params, (list, tuple)):
            for p in params:
                if not isinstance(p, Parameter):
                    raise MXNetError(f"not a Parameter: {type(p)}")
            names, items = [p.name for p in params], list(params)
        else:
            raise MXNetError("params must be a dict or a list of Parameter")
        if kvstore not in _LOCAL_STORES or compression_params is not None:
            raise MXNetError(
                f"kvstore={kvstore!r}, compression_params="
                f"{compression_params!r}: the port runs one process on one "
                "card; distributed stores and gradient compression are not "
                "ported (ROADMAP.md section 1, item 8)")
        self._param_names = names
        self._params: List[Parameter] = []
        for name, p in zip(names, items):
            if isinstance(p, torch.nn.Parameter):
                p = Parameter._of_tensor(name, p)
            elif not isinstance(p, Parameter):
                raise MXNetError(f"{name}: not a Parameter: {type(p)}")
            self._params.append(p)
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._optimizer.idx2name = dict(enumerate(self._param_names))
        self._scale = self._optimizer.rescale_grad
        self._states: Dict[int, object] = {}
        # the fused update's indices and their (lr mult, wd), fixed when
        # it is built
        self._fused_idxs: List[int] = []
        self._fused_mults: List[tuple] = []

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Sum the gradients over the workers: the identity on one card."""

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every trainable parameter from ``.grad / batch_size``,
        then clear the gradients."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def _state(self, i, w):
        """Index ``i``'s state: made on first use, a loaded host state
        moved to the weight's device."""
        opt = self._optimizer
        if i not in self._states:
            self._states[i] = opt.create_state_multi_precision(i, w)
        else:
            self._states[i] = to_device(self._states[i], w, opt)
        return self._states[i]

    def update(self, batch_size, ignore_stale_grad=False):
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        live = [(i, p.data()) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        stale = [self._param_names[i] for i, w in live if w.grad is None]
        if stale and not ignore_stale_grad:
            raise MXNetError(
                f"no gradient for {stale[:3]}{'...' if len(stale) > 3 else ''}"
                " since the last step: run backward first, or pass "
                "ignore_stale_grad=True")
        live = [(i, w) for i, w in live if w.grad is not None]
        if not live:
            return
        if opt.fusable:
            self._fused_update(live)
        else:
            for i, w in live:
                opt.update(i, w, w.grad, self._state(i, w))
        for i, w in live:
            if self._params[i].grad_req == "write":
                w.grad = None

    def _fused_update(self, live):
        opt = self._optimizer
        idxs = [i for i, _ in live]
        if idxs != self._fused_idxs:
            self._fused_idxs = idxs
            self._fused_mults = [(opt.lr_mult_of(i), opt._get_wd(i))
                                 for i in idxs]
        for i in idxs:
            opt._update_count(i)
        t = opt._index_update_count[idxs[0]]
        lr = onp.float32(opt.learning_rate)
        scale = float(onp.float32(opt.rescale_grad))
        clip = opt.clip_gradient
        with torch.no_grad():
            for (i, w), (lm, wd) in zip(live, self._fused_mults):
                g = w.grad.to(torch.promote_types(w.grad.dtype,
                                                  torch.float32)) * scale
                if clip is not None:
                    g = g.clamp_(-clip, clip)
                opt.apply(w, g, self._state(i, w),
                          float(lr * onp.float32(lm)), wd, t)

    # -- optimizer-state checkpoint -----------------------------------------
    def states_tree(self) -> dict:
        """The optimizer state as host numpy arrays with string keys, the
        reference's payload of a ``.states`` file: ``num_update``,
        ``index_update_count`` and ``states`` (index -> tuple, a
        multi-precision entry ``(master, inner tuple)``)."""
        opt = self._optimizer
        return {
            "num_update": int(opt.num_update),
            "index_update_count": {
                str(k): int(v) for k, v in opt._index_update_count.items()},
            "states": {str(i): to_host(s) for i, s in self._states.items()},
        }

    def load_states_tree(self, tree: dict) -> None:
        """Inverse of :meth:`states_tree` (int or str keys; lists read as
        tuples). States of initialized parameters move to their devices
        now, the others at their first update."""
        def canon(s):
            if isinstance(s, (list, tuple)):
                return tuple(canon(x) for x in s)
            return s

        opt = self._optimizer
        opt.num_update = int(tree["num_update"])
        opt._index_update_count = {
            int(k): int(v) for k, v in tree["index_update_count"].items()}
        self._states = {int(i): canon(s) for i, s in tree["states"].items()}
        for i in list(self._states):
            if self._params[i].initialized:
                self._state(i, self._params[i].data())

    def reset_states(self) -> None:
        """Forget all optimizer state and update counts; the next step
        creates them anew."""
        self._states = {}
        self._optimizer.num_update = 0
        self._optimizer._index_update_count = {}

    def save_states(self, fname):
        with open(fname, "wb") as f:
            pickle.dump(self.states_tree(), f)

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.load_states_tree(pickle.load(f))

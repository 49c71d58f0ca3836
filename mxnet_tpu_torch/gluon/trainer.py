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

A step follows the reference's fused update (``trainer.py:316-404,
459-490``): every updated index's count advances first, then the
learning rate is read once, rounded to float32, and the gradients are
scaled by ``rescale_grad`` in float32. The per-index lr and wd
multipliers are fixed when that update is first built (again only when
the set of updated indices changes), so ``set_lr_mult``/``set_wd_mult``
after the first step do not reach it. Optimizers that are not
``fusable`` (SGLD, Nadam) take :meth:`Optimizer.update` per parameter
instead, with the live multipliers, as the reference's eager path does.

The fused update is one function of three 0-d device scalars, ``lr``
(float32), ``rescale_grad`` (float32) and ``t`` (float64), the
counterpart of the reference's ``fused(weights, grads, states, lr,
rescale_grad, t)``: each step writes the current values into them and
runs it. On a CUDA device it runs as ONE CUDA graph (the reference's
one jitted program, ``_build_jit_step``): the first step of a key runs
the function eagerly (its warm-up) and captures it, the later ones
replay it. The key is the set of indices and the addresses of the
weights, the optimizer states and the gradients, so a new index set, a
``cast`` (new weight storage) or ``load_states`` (new state tensors)
captures anew. The graph reads the gradients where they lay at capture:
a hybridized block's backward graph writes them there every step (the
reference's gradient buffers that "back the next backward"); a gradient
found elsewhere (an eager backward's fresh tensor) is copied there
first. Multi-precision masters are updated inside the same graph. On
the CPU, and inside :func:`~.block._graphs_off`, the same function runs
eagerly; its arithmetic is the graph's, bitwise.
"""
from __future__ import annotations

import pickle
import time
from typing import Dict, List

import numpy as onp
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..optimizer.optimizer import to_device, to_host
from ..telemetry import tracing
from .block import _address, _graphs_on
from .parameter import Parameter

__all__ = ["Trainer"]

# kvstore names that mean one process on one card: the all-reduce is the
# identity
_LOCAL_STORES = (None, "device", "local", "none", "null")


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, torch.Tensor):
        yield tree


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
    with no store, the update runs here. ``captures``, ``replays`` and
    ``capture_s`` count the fused update's CUDA graphs."""

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
        # the fused update's device scalars (lr, rescale_grad, t) and its
        # CUDA graph: (key, graph, the gradients it reads)
        self._scalars = None
        self._graph = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

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
            self._graph = None
        for i in idxs:
            opt._update_count(i)
        t = opt._index_update_count[idxs[0]]
        weights = [w for _, w in live]
        states = [self._state(i, w) for i, w in live]
        dev = weights[0].device
        if self._scalars is None or self._scalars[0].device != dev:
            self._scalars = (torch.zeros((), device=dev),
                             torch.zeros((), device=dev),
                             torch.zeros((), dtype=torch.float64,
                                         device=dev))
        lr, scale, step = self._scalars
        lr.fill_(float(onp.float32(opt.learning_rate)))
        scale.fill_(float(onp.float32(opt.rescale_grad)))
        step.fill_(float(t))
        grads = [w.grad for w in weights]
        if dev.type != "cuda" or not _graphs_on():
            self._fused(weights, grads, states)
            return
        key = (tuple(idxs), opt.clip_gradient,
               tuple(_address(w) for w in weights),
               tuple(_address(s) for s in _leaves(states)))
        if self._graph is None or self._graph[0] != key:
            self._capture(key, weights, grads, states)
            return
        _, graph, held = self._graph
        for buf, g in zip(held, grads):
            if _address(buf) != _address(g):
                buf.copy_(g)
        graph.replay()
        self.replays += 1

    def _fused(self, weights, grads, states):
        """The fused update of every live index from the device scalars
        (the reference's ``fused``; its graph when captured)."""
        opt = self._optimizer
        lr, scale, t = self._scalars
        clip = opt.clip_gradient
        rates = {}
        with torch.no_grad(), opt.scalar_memo():
            for w, g, st, (lm, wd) in zip(weights, grads, states,
                                          self._fused_mults):
                if lm not in rates:
                    rates[lm] = lr if lm == 1.0 else lr * lm
                g = g.to(torch.promote_types(g.dtype, torch.float32)) * scale
                if clip is not None:
                    g = g.clamp_(-clip, clip)
                opt.apply(w, g, st, rates[lm], wd, t)

    def _capture(self, key, weights, grads, states):
        """The first step of a key: the update eagerly (which also warms
        every kernel up), then its capture on a side stream, reading the
        gradients at this step's addresses (held from now on)."""
        from .model_zoo.generation import _capture_stream

        t0 = time.perf_counter()
        self._fused(weights, grads, states)
        dev = weights[0].device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self._fused(weights, grads, states)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph = (key, graph, list(grads))
        dt = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += dt
        tracing.attribute("compile", dt)

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
        self._graph = None
        for i in list(self._states):
            if self._params[i].initialized:
                self._state(i, self._params[i].data())

    def reset_states(self) -> None:
        """Forget all optimizer state and update counts; the next step
        creates them anew."""
        self._states = {}
        self._graph = None
        self._optimizer.num_update = 0
        self._optimizer._index_update_count = {}

    def save_states(self, fname):
        with open(fname, "wb") as f:
            pickle.dump(self.states_tree(), f)

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.load_states_tree(pickle.load(f))

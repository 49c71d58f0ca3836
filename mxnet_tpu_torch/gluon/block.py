"""Gluon Block and HybridBlock of the PyTorch port (counterpart of
``mxnet_tpu/gluon/block.py``).

A :class:`Block` is a ``torch.nn.Module``. Assigning a Gluon
:class:`~.parameter.Parameter` to an attribute registers it (``_reg_params``)
and registers its tensor with the module under the same name, so
``net.weight`` is the Gluon Parameter while ``state_dict()``,
``named_parameters()`` and ``load_state_dict()`` see the tensor; child
blocks register as torch submodules. So :meth:`Block.collect_params`'
dotted names are ``state_dict()``'s keys, and they equal the JAX
package's names for the same net. A ``torch.nn.Parameter`` assigned the
torch way is collected too, under a Parameter made over it.

``initialize`` sets every parameter's initializer and device (default
``Uniform(0.07)`` on ``gpu(0)``); parameters whose shape has zeros are
made at the first forward, when the layer knows its input. Forward
hooks are torch's (``hook(block, inputs, output)``, as the reference's).
:meth:`Block.functionalize` runs the forward with the caller's tensors:
those that layers read through ``Parameter.data()`` by
:func:`~.parameter.substituted`, and those registered the torch way by
``torch.func.functional_call``.

``HybridBlock.hybridize()`` is the reference's compiled forward (one XLA
program per input signature) on this card: a hybridized block on a CUDA
device replays CUDA graphs. Outside ``autograd.record()`` it replays one
forward graph per key (:class:`~.model_zoo.generation.GraphedProgram`).
While recording it records ONE autograd node per call whose forward
replays a captured forward graph and whose backward replays the
captured backward graph of that forward (:class:`_CachedGraph`, the
reference's ``_CachedGraph`` of ``fwd_fn`` and ``bwd_fn``, with
:class:`_CachedOp` as its tape node). On the CPU the same node runs
its forward and backward eagerly (:class:`_EagerGraph`). ``infer_shape``
runs the forward on torch's ``meta`` device (the counterpart of
``jax.eval_shape``); ``optimize_for`` applies a pass of
:mod:`~mxnet_tpu_torch.contrib.passes` and hybridizes. ``export`` and
``SymbolBlock`` are not ported (ROADMAP.md section 1, item 10).
"""
from __future__ import annotations

import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree

from .. import autograd
from ..base import MXNetError
from ..context import resolve_device
from .. import initializer as init_mod
from .. import serialization
from ..ops.nn import generator, using_generator
from .parameter import Parameter, shapes_only, substituted

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_NO_SYMBOL = ("the reference's symbol graph (symbol/, export, SymbolBlock) "
              "is not ported (ROADMAP.md section 1, item 10)")


class _HookHandle:
    """The reference's hook handle (``detach``) over torch's."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach


class Block(nn.Module):
    """Base model component (reference block.py:251), an ``nn.Module``."""

    def __init__(self):
        super().__init__()
        self._reg_params: Dict[str, Parameter] = {}

    # -- attribute registration -----------------------------------------------
    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter):
            if reg is None:
                raise MXNetError("call Block.__init__() before assigning "
                                 "parameters")
            if value._name in ("weight", "param", "") or value._name is None:
                value._name = name
            self.register_parameter(name, value._var)
            object.__setattr__(self, name, value)
            reg[name] = value
            return
        if reg is not None and name in reg:
            del reg[name]
            self.__dict__.pop(name, None)
            self._parameters.pop(name, None)
        super().__setattr__(name, value)

    def register_child(self, block: nn.Module, name: Optional[str] = None):
        self.add_module(name or str(len(self._modules)), block)

    # -- parameter collection -------------------------------------------------
    def _own_params(self):
        """(name, Parameter) of this block's own tensors, in registration
        order; a torch-registered ``nn.Parameter`` gets a Parameter made
        over it."""
        for name, var in self._parameters.items():
            if var is None:
                continue
            p = self._reg_params.get(name)
            if p is None or p._var is not var:
                p = self._reg_params[name] = Parameter._of_tensor(name, var)
            yield name, p

    def _collect(self, out: Dict[str, Parameter], prefix: str):
        for name, p in self._own_params():
            out[prefix + name] = p
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                child._collect(out, prefix + cname + ".")
            elif child is not None:
                for n, var in child.named_parameters(
                        prefix=prefix + cname, remove_duplicate=False):
                    out[n] = Parameter._of_tensor(n, var)

    def collect_params(self, select: Optional[str] = None
                       ) -> Dict[str, Parameter]:
        """Dotted name -> Parameter of this block and its children (the
        keys of ``state_dict()``); ``select`` is a regular expression the
        names must match."""
        out: Dict[str, Parameter] = {}
        self._collect(out, "")
        if select is not None:
            pat = re.compile(select)
            out = {k: v for k, v in out.items() if pat.search(k)}
        return out

    @property
    def params(self) -> Dict[str, Parameter]:
        return dict(self._own_params())

    # -- lifecycle ----------------------------------------------------------------
    def initialize(self, init=None, device=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``device`` (default ``gpu(0)``)
        with its own initializer, else ``init``, else ``Uniform(0.07)``;
        deferred shapes are initialized at the first forward."""
        dev = resolve_device(device if device is not None else ctx)
        default = init or init_mod.Uniform(0.07)
        for name, p in self.collect_params().items():
            p._name = name   # fully qualified, for the initializer's rules
            p.initialize(init=p.init, device=dev, default_init=default,
                         force_reinit=force_reinit)
        return self

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        self._dtype = dtype
        return self

    def zero_grad(self, set_to_none: bool = False):
        """Set every parameter's gradient to zeros (the reference's
        ``zero_grad``; ``set_to_none=True`` drops them, as torch's)."""
        for p in self.collect_params().values():
            if set_to_none and p.initialized:
                p._var.grad = None
            else:
                p.zero_grad()

    def hybridize(self, active: bool = True, **kwargs):
        """Hybridize (or, with ``active=False``, un-hybridize) the
        HybridBlocks among the children; a plain Block runs eagerly."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def functionalize(self, *example_args, training: bool = False):
        """This block's forward as a function of its parameters
        (reference ``block.py:685``): every ``Parameter.data()`` read
        returns the caller's tensor (:func:`~.parameter.substituted`),
        and ``torch.func.functional_call`` substitutes the tensors
        registered the torch way.

        Returns ``(fn, params)``: ``params`` maps every
        :meth:`collect_params` name to its tensor (detached, sharing the
        parameter's storage), and ``fn(params, *inputs, key=None)``
        returns ``(outputs, new_params)``. ``new_params`` is ``params``
        with the state a forward updates (BatchNorm's running
        statistics, under ``training=True``) replaced by new tensors:
        ``fn`` writes those into copies and leaves ``params`` and the
        block unchanged. ``training`` selects the mode of BatchNorm and
        Dropout, as the reference's; ``key``, a ``torch.Generator``, is
        what random draws take instead of the device's generator. A
        hybridized block runs eagerly inside ``fn``. Deferred shapes are
        completed by one forward on ``example_args`` in predict mode."""
        from torch.func import functional_call

        if not all(p.initialized for p in self.collect_params().values()):
            with autograd.pause(train_mode=False), _graphs_off():
                self(*example_args)
        named = self.collect_params()
        params = {n: p.data().detach() for n, p in named.items()}
        # what a training forward writes in place: copies of it, per call
        state = ([n for n, p in named.items() if not p._differentiable]
                 if training else [])
        mode = autograd.train_mode if training else autograd.predict_mode

        def fn(params, *inputs, key=None):
            new = dict(params)
            new.update((n, params[n].clone()) for n in state)
            with mode(), _graphs_off(), using_generator(key), \
                    substituted((p, new[n]) for n, p in named.items()):
                out = functional_call(self, new, inputs)
            return out, new

        return fn, params

    # -- checkpointing (reference block.py:440 / :496) -------------------------
    def save_parameters(self, filename: str, deduplicate: bool = False):
        """Write every initialized parameter to a ``.params`` file (the
        reference's format, loadable by the JAX package)."""
        serialization.save_params(filename, {
            name: p.data() for name, p in self.collect_params().items()
            if p.initialized})

    def load_parameters(self, filename: str, device=None, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype: bool = False,
                        dtype_source: str = "current"):
        """Load a ``.params`` file (written by either package) into the
        parameters, in their dtypes. An initialized parameter keeps its
        device; an uninitialized one is made on ``device``, else its
        initialize() device, else ``gpu(0)``."""
        self.load_dict(serialization.load_params(filename),
                       device if device is not None else ctx,
                       allow_missing, ignore_extra, what=filename)

    def load_dict(self, param_dict, device=None, allow_missing=False,
                  ignore_extra=False, what="dict"):
        params = self.collect_params()
        for name, p in params.items():
            if name in param_dict:
                p.set_data(param_dict[name], device=device)
            elif not allow_missing:
                raise MXNetError(f"Parameter {name} missing in {what}")
        extra = set(param_dict) - set(params)
        if extra and not ignore_extra:
            raise MXNetError(f"{what} has extra parameters {sorted(extra)}")

    # -- hooks --------------------------------------------------------------------
    def register_forward_hook(self, hook):
        """``hook(block, inputs, output)`` after each forward."""
        return _HookHandle(super().register_forward_hook(hook))

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before each forward; it may return new
        inputs."""
        return _HookHandle(super().register_forward_pre_hook(hook))

    def forward(self, *args):
        raise NotImplementedError


class _GraphsOff(threading.local):
    def __init__(self):
        self.depth = 0


_graphs_off_state = _GraphsOff()


@contextmanager
def _graphs_off():
    """Inside the scope hybridized blocks run eagerly and the Trainer's
    fused update runs as Python launches: the eager side of a comparison
    with the graphs (``functionalize``'s ``fn`` runs in it too, since it
    substitutes tensors that a captured graph would not read).
    Re-entrant and thread-local."""
    _graphs_off_state.depth += 1
    try:
        yield
    finally:
        _graphs_off_state.depth -= 1


def _graphs_on() -> bool:
    return not _graphs_off_state.depth


def _address(t):
    """Where a graph reads a tensor: its storage, shape, strides and
    dtype."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def _counts():
    from ..ops.kernels import _build
    return [w.launches for w in _build.COUNTED]


def _launched(before):
    """What each counted wrapper launched since ``before``, taken back
    off its count: a capture launches nothing."""
    from ..ops.kernels import _build
    out = []
    for w, n in zip(_build.COUNTED, before):
        if w.launches != n:
            out.append((w, w.launches - n))
            w.launches = n
    return tuple(out)


class _Call:
    """One recorded call: the pytree spec of its outputs (filled by the
    graph's ``forward``)."""

    __slots__ = ("spec",)


class _CachedOp(torch.autograd.Function):
    """The tape node of a hybridized call (the reference's
    ``_invoke_cached`` TapeNode): inputs are the call's tensors, then the
    parameters it differentiates; forward runs ``graph.forward``,
    backward ``graph.backward``."""

    @staticmethod
    def forward(ctx, graph, call, n_args, *tensors):
        outs, call.spec, handle = graph.forward(tensors[:n_args])
        ctx.graph, ctx.handle = graph, handle
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        grads = ctx.graph.backward(ctx.handle, gouts)
        ctx.handle = None
        return (None, None, None) + tuple(grads)


class _Structure:
    """What a recorded call differentiates and what it mutates (the
    reference's ``diff_idx`` and ``mutated_params``): the inputs that
    require grad, every parameter whose ``grad_req`` is not null, and
    the state a training forward writes in place (BatchNorm's running
    statistics), which the call reads and updates where it lies.

    The body differentiates detached aliases of the parameters (read
    through ``Parameter.data()`` and, for tensors registered the torch
    way, through the module), as ``functionalize``'s fn does: leaves of
    its own, so that no gradient accumulator of the caller's graph
    (made on another stream, and kept alive by the caller's tensors)
    takes part in a captured backward."""

    def __init__(self, block, args):
        self.block = block
        self.diff_args = [a.requires_grad and a.is_floating_point()
                          for a in args]
        named = [(n, p) for n, p in block.collect_params().items()
                 if p._var.requires_grad]
        self.names = [n for n, _ in named]
        self.gluon = [p for _, p in named]
        self.params = [p.data() for p in self.gluon]
        self.state = [p.data() for p in block.collect_params().values()
                      if not p._var.requires_grad]

    def leaves(self, args):
        """(the inputs as leaves, the parameters' aliases)."""
        return ([a.detach().requires_grad_(d)
                 for a, d in zip(args, self.diff_args)],
                [v.detach().requires_grad_() for v in self.params])

    def body(self, leaves, aliases):
        from torch.nn.utils.stateless import _reparametrize_module

        with torch.enable_grad(), _graphs_off(), \
                substituted(zip(self.gluon, aliases)), \
                _reparametrize_module(self.block,
                                      dict(zip(self.names, aliases))):
            return self.block.forward(*leaves)

    def diff_inputs(self, leaves, aliases):
        return [t for t, d in zip(leaves, self.diff_args) if d] + aliases

    def grads_out(self, grads):
        """The node's input gradients from those of :meth:`diff_inputs`:
        None for each input that is not differentiated."""
        it = iter(grads)
        return [next(it) if d else None for d in self.diff_args] + list(it)


class _EagerGraph(_Structure):
    """The node's forward and backward run eagerly (the CPU): the
    forward builds its own autograd graph from detached inputs and the
    parameters' aliases, which the backward differentiates."""

    def forward(self, args):
        leaves, aliases = self.leaves(args)
        out = self.body(leaves, aliases)
        flat, spec = pytree.tree_flatten(out)
        outs = [o for o in flat if isinstance(o, torch.Tensor)]
        return ([o.detach() for o in outs], spec,
                (outs, self.diff_inputs(leaves, aliases)))

    def backward(self, handle, gouts):
        outs, inputs = handle
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                    [g for _, g in pairs], allow_unused=True)
        return self.grads_out(grads)


class _Lease:
    """Marks a :class:`_CachedGraph` busy from its forward replay until
    its backward, or until the node is dropped without one: a second
    call of the same key meanwhile takes another graph pair, so no
    replay overwrites what a pending backward reads. Releasing a pair
    that is not the first of its key drops it from the block (its pool
    is freed with the last node that holds it)."""

    def __init__(self, graph):
        self.graph = graph
        graph.busy = True

    def release(self):
        graph, self.graph = self.graph, None
        if graph is not None:
            graph.busy = False
            if graph.slots is not None and graph in graph.slots:
                graph.slots.remove(graph)

    __del__ = release


class _CachedGraph(_Structure):
    """One key's forward and backward CUDA graphs (the reference's
    ``_CachedGraph``: ``fwd_fn`` and ``bwd_fn``).

    Built at the first call of its key: one forward and backward run
    eagerly on a side stream (the warm-up torch requires; it loads every
    kernel), the training state it moved put back, then the forward
    (with the dropout generator registered, so each replay draws new
    masks) and the backward of that forward captured into one memory
    pool. The saved activations and masks stay in the pool, where the
    backward graph reads those of its own forward. The forward reads
    the inputs from static buffers it copies them into and the
    parameters and state where they lie (their addresses are in the
    key); its outputs are handed out as copies. The backward reads the
    output gradients from static buffers and copies the parameters'
    gradients into buffers allocated outside the pool before either
    capture, so that no replay of the forward (whose temporaries reuse
    the pool) writes over them: autograd hands them on to ``.grad`` as
    they are (so the Trainer's update graph finds them at the same
    address every step), the inputs' gradients as copies. Each replay
    adds what its capture launched to every counted wrapper's
    ``.launches``. ``slots`` is the block's list of pairs of this key
    when the pair is not its first (:class:`_Lease` drops it)."""

    def __init__(self, block, args, generator, slots=None):
        super().__init__(block, args)
        from .model_zoo.generation import _capture_stream

        t0 = time.perf_counter()
        dev = block._device(args)
        self.busy = False
        self.slots = slots
        self.param_grads = [torch.empty_like(v) for v in self.params]
        self.static, aliases = self.leaves([a.clone() for a in args])
        inputs = self.diff_inputs(self.static, aliases)
        cur = torch.cuda.current_stream(dev)
        side = _capture_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            kept = [(t, t.clone()) for t in self.state]
            flat = [o for o in pytree.tree_leaves(
                        self.body(self.static, aliases))
                    if isinstance(o, torch.Tensor) and o.requires_grad]
            if flat:
                torch.autograd.grad(flat, inputs,
                                    [torch.ones_like(o) for o in flat],
                                    allow_unused=True)
            del flat
            with torch.no_grad():
                for t, was in kept:
                    t.copy_(was)
            del kept
        cur.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.fwd = torch.cuda.CUDAGraph()
        self.fwd.register_generator_state(generator)
        before = _counts()
        with torch.cuda.graph(self.fwd, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            out = self.body(self.static, aliases)
        self.fwd_launches = _launched(before)
        flat, self.spec = pytree.tree_flatten(out)
        self.outs = [o for o in flat if isinstance(o, torch.Tensor)]
        self.diff_outs = [i for i, o in enumerate(self.outs)
                          if o.requires_grad]
        self.gouts = [torch.empty_like(self.outs[i])
                      for i in self.diff_outs]
        self.bwd = torch.cuda.CUDAGraph()
        n_in = sum(self.diff_args)
        before = _counts()
        with torch.cuda.graph(self.bwd, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            grads = (torch.autograd.grad(
                [self.outs[i] for i in self.diff_outs], inputs, self.gouts,
                allow_unused=True) if self.diff_outs else
                [None] * len(inputs))
            for buf, g in zip(self.param_grads, grads[n_in:]):
                if g is not None:
                    buf.copy_(g)
            self.grads = list(grads[:n_in]) + [
                None if g is None else buf
                for buf, g in zip(self.param_grads, grads[n_in:])]
            del grads
        self.bwd_launches = _launched(before)
        self.outs = [o.detach() for o in self.outs]
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        from ..telemetry import tracing
        tracing.attribute("compile", self.capture_s)

    def forward(self, args):
        for buf, a in zip(self.static, args):
            if buf.data_ptr() != a.data_ptr():
                buf.copy_(a)
        self.fwd.replay()
        for w, n in self.fwd_launches:
            w.launches += n
        return [o.clone() for o in self.outs], self.spec, _Lease(self)

    def backward(self, lease, gouts):
        for buf, i in zip(self.gouts, self.diff_outs):
            buf.copy_(gouts[i])
        n_in = sum(self.diff_args)
        for var, g in zip(self.params, self.grads[n_in:]):
            # a gradient not yet consumed that lies in the buffer this
            # replay rewrites: keep it, autograd then adds the new one
            if (g is not None and var.grad is not None
                    and var.grad.data_ptr() == g.data_ptr()):
                var.grad = var.grad.clone()
        self.bwd.replay()
        for w, n in self.bwd_launches:
            w.launches += n
        lease.release()
        return self.grads_out(
            [None if g is None else g.clone() if k < n_in else g.detach()
             for k, g in enumerate(self.grads)])


class HybridBlock(Block):
    """A Block whose forward the reference traces into one program
    (reference block.py:854).

    After :meth:`hybridize`, a call with tensor inputs and no keyword
    arguments, on parameters that lie on a CUDA device, replays CUDA
    graphs. Outside ``autograd.record()`` it replays a graph of the
    forward: one graph per key, which is the inputs' shapes and dtypes,
    the training flag, the matmul precision policy, the AMP policy's
    version, :class:`~...ops.nn.no_kernels`, and every parameter's
    address, shape and dtype. While recording, it records one autograd node per call
    whose forward and backward replay a captured pair of graphs
    (:class:`_CachedGraph`), one pair per key, which adds which inputs
    are differentiated. A pair's memory pool holds the activations,
    masks and temporaries of one forward and backward (what eager frees
    after each backward), and the pair the parameters' gradient
    buffers, for as long as the pair lives. A key's first pair lives
    until ``hybridize()`` is called again; each input shape is a key,
    so a smaller last batch keeps one more. A pair captured because the
    key's first was busy (a call recorded before the backward of an
    earlier one) is dropped once its own backward has run, so K calls
    of a key pending at once capture K - 1 pairs anew each time. After
    a ``cast`` (new storage) the next call
    captures anew; what ``load_parameters`` or ``set_data`` write in
    place the next replay reads. The first call of a key runs the
    forward (and, recording, the backward) once and captures it; a
    training-mode forward's BatchNorm statistics move once per call all
    the same. Forward hooks run around each call, as the reference's
    around its cached program. The outputs are copies of the graph's,
    which the next replay overwrites. On the CPU a recorded call runs
    the same node eagerly (:class:`_EagerGraph`), and any other call
    runs the forward as it is, as it does before ``hybridize()``, after
    ``hybridize(False)`` and inside :func:`_graphs_off`. ``captures`` and
    ``replays`` count the block's graphs (a recorded pair counts once)."""

    def __init__(self):
        super().__init__()
        self._active = False
        self._programs: Dict[tuple, object] = {}
        self._train_graphs: Dict[tuple, List[_CachedGraph]] = {}
        # recorded pairs: captures, replays, capture seconds
        self._pairs = [0, 0, 0.0]

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, inline_limit: int = 2,
                  backend=None, backend_opts=None, **kwargs):
        """Replay the forward as CUDA graphs (``active=False``: run it
        eagerly and drop the graphs). The reference's compile options
        are accepted; only the outermost hybridized block captures, its
        children run inside its graph."""
        self._active = active
        self._programs = {}
        self._train_graphs = {}
        self._pairs = [0, 0, 0.0]
        super().hybridize(False)

    @property
    def captures(self) -> int:
        return (sum(p.captures for p in self._programs.values())
                + self._pairs[0])

    @property
    def replays(self) -> int:
        return (sum(p.replays for p in self._programs.values())
                + self._pairs[1])

    @property
    def capture_s(self) -> float:
        return (sum(p.capture_s for p in self._programs.values())
                + self._pairs[2])

    def __call__(self, *args, **kwargs):
        route = None if kwargs else self._route(args)
        if route is None:
            return super().__call__(*args, **kwargs)
        for hook in self._forward_pre_hooks.values():
            new = hook(self, args)
            if new is not None:
                args = new if isinstance(new, tuple) else (new,)
        if route == "record":
            out = self._call_recorded(args)
        else:
            out = self._replay(args, [p.data() for p in
                                      self.collect_params().values()])
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def _route(self, args):
        """"record" (one recorded node), "replay" (a forward graph), or
        None (the call runs eagerly)."""
        if (not self._active or not _graphs_on()
                or not all(isinstance(a, torch.Tensor) for a in args)):
            return None
        params = list(self.collect_params().values())
        if not all(p.initialized for p in params):
            return None         # the eager call completes the shapes
        tensors = [p.data() for p in params] + list(args)
        cuda = all(t.is_cuda for t in tensors)
        if autograd.is_recording() and torch.is_grad_enabled():
            return "record" if cuda or not any(
                t.is_cuda for t in tensors) else None
        return "replay" if cuda else None

    def _call_recorded(self, args):
        """One :class:`_CachedOp` node over this call: its graph pair on
        the card, the eager split on the CPU."""
        training = autograd.is_training()
        dev = self._device(args)
        if dev.type == "cuda":
            graph = self._train_graph(args, training, dev)
            self._pairs[1] += 1
        else:
            graph = _EagerGraph(self, args)
        call = _Call()
        outs = _CachedOp.apply(graph, call, len(args), *args, *graph.params)
        return pytree.tree_unflatten(list(outs), call.spec)

    def _device(self, args):
        tensors = list(args) or [p.data() for p in
                                 self.collect_params().values()]
        return tensors[0].device

    def _train_graph(self, args, training, dev):
        from .model_zoo.generation import routing_key

        gen = generator(dev)
        params = [p.data() for p in self.collect_params().values()]
        key = (training, id(gen),
               tuple((tuple(a.shape), a.dtype, a.requires_grad)
                     for a in args),
               tuple(_address(t) + (t.requires_grad,) for t in params),
               routing_key(dev))
        slots = self._train_graphs.setdefault(key, [])
        for g in slots:
            if not g.busy:
                return g
        graph = _CachedGraph(self, args, gen, slots if slots else None)
        slots.append(graph)
        self._pairs[0] += 1
        self._pairs[2] += graph.capture_s
        return graph

    def _replay(self, args, params):
        from .model_zoo.generation import GraphedProgram

        training = autograd.is_training()
        prog = self._programs.get((training, len(args)))
        if prog is None:
            n = len(args)

            def body(*call):
                with torch.no_grad():
                    return self.forward(*call[:n])

            state = [p.data() for p in self.collect_params().values()
                     if not p._differentiable]
            prog = self._programs[(training, n)] = GraphedProgram(
                f"{type(self).__name__}.forward", body, range(n),
                (id(self), training), training, state=lambda: state)
        out = prog(*args, *params, generator(self._device(args)))
        if isinstance(out, (tuple, list)):
            return type(out)(t.clone() for t in out)
        return out.clone()

    # -- shapes and passes ------------------------------------------------
    def infer_shape(self, *args):
        """Complete every deferred parameter shape without running the
        net (reference ``block.py:298``, ``jax.eval_shape``): the forward
        runs in predict mode on torch's ``meta`` device, where every op,
        the kernel wrappers' included, computes shapes only and every
        parameter reads as a ``meta`` tensor of its shape
        (:func:`~.parameter.shapes_only`). Then each parameter whose
        shape the layers completed is made on its device and
        initialized. Returns the outputs' shapes (a shape, or the
        outputs' structure of them)."""
        meta = torch.device("meta")
        inputs = [a.to(meta) if isinstance(a, torch.Tensor) else a
                  for a in args]
        with autograd.pause(train_mode=False), _graphs_off(), shapes_only():
            out = self.forward(*inputs)
        for p in self.collect_params().values():
            p.finalize()
        return pytree.tree_map(
            lambda t: tuple(t.shape) if isinstance(t, torch.Tensor) else t,
            out)

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Not ported: raises :class:`MXNetError` (the reference writes
        its symbol JSON and ``.params``)."""
        raise MXNetError(f"HybridBlock.export: {_NO_SYMBOL}")

    def optimize_for(self, x, *args, backend=None, clear=True, **kwargs):
        """Apply a registered pass of :mod:`~...contrib.passes`, then
        hybridize and run the block once (reference ``block.py:326``).
        ``backend=None`` reads ``MXNET_SUBGRAPH_BACKEND`` ("NONE" or
        unset: no pass), as the reference does. Deferred shapes are
        completed first (:meth:`infer_shape`), since a pass reads the
        weights."""
        if backend is None:
            backend = os.environ.get("MXNET_SUBGRAPH_BACKEND") or None
            if backend is not None and backend.upper() == "NONE":
                backend = None
        if backend is not None:
            from ..contrib.passes import apply_pass

            if not all(p.initialized for p in
                       self.collect_params().values()):
                self.infer_shape(x, *args)
            apply_pass(self, backend)
        self.hybridize(True, **kwargs)
        return self(x, *args)




class SymbolBlock(HybridBlock):
    """Not ported: building one, or ``SymbolBlock.imports``, raises
    :class:`MXNetError` (the reference runs a loaded symbol graph)."""

    def __init__(self, outputs=None, inputs=None, params=None):
        raise MXNetError(f"SymbolBlock: {_NO_SYMBOL}")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, device=None):
        raise MXNetError(f"SymbolBlock.imports: {_NO_SYMBOL}")

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
program per input signature) on this card: outside ``autograd.record()``
a hybridized block on a CUDA device replays one CUDA graph per key
(:class:`~.model_zoo.generation.GraphedProgram`). While recording, and
on the CPU, it runs eagerly. ``export``, ``SymbolBlock`` and
``optimize_for`` are not ported.
"""
from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..context import resolve_device
from .. import initializer as init_mod
from .. import serialization
from ..ops.nn import generator, using_generator
from .parameter import Parameter, substituted

__all__ = ["Block", "HybridBlock"]


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
    """Hybridized blocks run eagerly inside the scope (``functionalize``
    substitutes tensors that a captured graph would not read)."""
    _graphs_off_state.depth += 1
    try:
        yield
    finally:
        _graphs_off_state.depth -= 1


class HybridBlock(Block):
    """A Block whose forward the reference traces into one program
    (reference block.py:854).

    After :meth:`hybridize`, a call outside ``autograd.record()`` with
    tensor inputs and no keyword arguments, on parameters that lie on a
    CUDA device, replays a CUDA graph of the forward: one graph per key,
    which is the inputs' shapes and dtypes, the training flag, the
    matmul precision policy, :class:`~...ops.nn.no_kernels`, and every
    parameter's address, shape and dtype. After a ``cast`` (new storage)
    the next call captures anew; what ``load_parameters`` or
    ``set_data`` write in place the next replay reads. The first call of
    a key runs the forward once and captures it; a training-mode
    forward's BatchNorm statistics move once per call all the same.
    Forward hooks run around each call, as the reference's around its
    cached program. The outputs are copies of the graph's, which the
    next replay overwrites. While recording, and on the CPU, the block
    runs eagerly, as it does before ``hybridize()`` and after
    ``hybridize(False)``. ``captures`` and ``replays`` count the block's
    graphs."""

    def __init__(self):
        super().__init__()
        self._active = False
        self._programs: Dict[tuple, object] = {}

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, inline_limit: int = 2,
                  backend=None, backend_opts=None, **kwargs):
        """Replay the forward as CUDA graphs (``active=False``: run it
        eagerly and drop the graphs). The reference's compile options
        are accepted; only the outermost hybridized block captures, its
        children run inside its graph."""
        self._active = active
        self._programs = {}
        super().hybridize(False)

    @property
    def captures(self) -> int:
        return sum(p.captures for p in self._programs.values())

    @property
    def replays(self) -> int:
        return sum(p.replays for p in self._programs.values())

    def __call__(self, *args, **kwargs):
        params = None if kwargs else self._graph_params(args)
        if params is None:
            return super().__call__(*args, **kwargs)
        for hook in self._forward_pre_hooks.values():
            new = hook(self, args)
            if new is not None:
                args = new if isinstance(new, tuple) else (new,)
        out = self._replay(args, params)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def _graph_params(self, args):
        """The parameters' tensors when this call replays a graph, else
        None (the call runs eagerly)."""
        if (not self._active or _graphs_off_state.depth
                or autograd.is_recording()
                or not all(isinstance(a, torch.Tensor) for a in args)):
            return None
        params = list(self.collect_params().values())
        if not all(p.initialized for p in params):
            return None         # the eager call completes the shapes
        tensors = [p.data() for p in params]
        if not all(t.is_cuda for t in tensors or args):
            return None
        return tensors

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
        gen = generator(params[0].device if params else args[0].device)
        out = prog(*args, *params, gen)
        if isinstance(out, (tuple, list)):
            return type(out)(t.clone() for t in out)
        return out.clone()

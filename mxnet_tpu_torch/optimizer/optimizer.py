"""Optimizers of the PyTorch port (counterpart of
``mxnet_tpu/optimizer/optimizer.py``): the ``Optimizer`` base (learning
rate and its scheduler, weight decay, ``rescale_grad``,
``clip_gradient``, per-parameter lr/wd multipliers, ``multi_precision``),
the registry, the reference's 17 optimizers under its names and
aliases, and ``Updater``/``get_updater``.

The update rules are the reference's, written out in torch (not
``torch.optim``, whose Adam places epsilon inside the bias correction).
Unlike the reference's pure rules, these update the weight and the
state tensors in place, so a step allocates no second copy of them. A
rule may also write into the gradient it is given: :meth:`update` and
the Trainer hand it a scaled copy, never the caller's ``.grad``.

``multi_precision``: a float16 or bfloat16 weight's state is
``(float32 master, inner state)``; the rule runs on the master with the
gradient in float32, and the weight becomes the master rounded to its
dtype. State blobs (:meth:`Updater.get_states`, the Trainer's
``.states`` files) hold host numpy arrays in the reference's layout, so
that a blob written by either package loads in the other.
"""
from __future__ import annotations

import math
import pickle
from contextlib import contextmanager
from typing import Dict, Tuple

import numpy as onp
import torch

from ..base import MXNetError, env_int
from ..ops.nn import generator

__all__ = ["Optimizer", "register", "create", "Updater", "get_updater",
           "SGD", "NAG", "Signum", "SGLD", "DCASGD", "LARS", "Adam", "AdamW",
           "Adamax", "Nadam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "FTML", "LAMB", "GroupAdaGrad"]

_registry: Dict[str, type] = {}
_HALF = (torch.float16, torch.bfloat16)


def register(klass):
    _registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    """Instantiate a registered optimizer by (case-insensitive) name."""
    if isinstance(name, Optimizer):
        return name
    try:
        klass = _registry[name.lower()]
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_registry)}") from None
    return klass(**kwargs)


def _sqrt(x):
    """sqrt of a Python number or of a 0-d tensor (a rule's scalar on the
    device-scalar route)."""
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _norm(x):
    """A tensor's L2 norm as a float64 scalar tensor, its squares summed in
    float64: a float32 sum of an embedding's 24.6M squares drifts by up
    to 5e-4 of the norm between a CPU and the card."""
    return torch.linalg.vector_norm(x, dtype=torch.float64)


def is_master_state(state) -> bool:
    """Whether ``state`` is a multi-precision ``(master, inner)`` pair
    (the inner state is itself a tuple)."""
    return (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[1], tuple))


class Optimizer:
    """Base optimizer. :meth:`update` applies the rule of
    :meth:`update_step` to one parameter: the gradient is scaled by
    ``rescale_grad`` and clipped to ``clip_gradient``, and the learning
    rate (``lr_scheduler(num_update)`` when a scheduler is set) and weight
    decay carry the parameter's multipliers: ``param_dict[index]``'s
    ``lr_mult``/``wd_mult``, else ``set_lr_mult``/``set_wd_mult``'s entry
    for the index, else for its name.

    ``fusable`` (the reference's ``jit_safe``): the Trainer may take one
    learning rate for all parameters of a step. SGLD (fresh noise) and
    Nadam (a schedule advanced per parameter) are not, and the Trainer
    calls their :meth:`update` per parameter.

    The rules take ``lr`` and ``t`` as Python numbers (:meth:`update`) or
    as 0-d tensors on the weights' device (the Trainer's fused update,
    whose CUDA graph reads them where they lie: ``lr`` float32, ``t``
    float64, so ``beta ** t`` is taken in float64 as the reference's
    traced ``t`` widens it). Their arithmetic on a tensor scalar is the
    same torch ops whether the update runs eagerly or replays, so the
    two agree bitwise. A scalar derived from ``lr`` and ``t`` alone (a
    bias correction) is made once per step inside :meth:`scalar_memo`,
    not once per parameter."""

    fusable = True

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, aggregate_num=None,
                 use_fused_step=None, **kwargs):
        # how many weights one fused update covers in the reference's
        # CUDA build; kept for its API: the port updates per parameter
        if aggregate_num is None:
            aggregate_num = max(env_int("MXNET_OPTIMIZER_AGGREGATION_SIZE",
                                        4), 1)
        self.aggregate_num = aggregate_num
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            # warmup_final_lr keeps the scheduler's own base_lr, as in
            # the reference
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = dict(param_dict or {})
        self.lr_mult: Dict = {}
        self.wd_mult: Dict = {}
        self._kwargs = kwargs
        self._memo = None

    @contextmanager
    def scalar_memo(self):
        """Inside the scope, :meth:`_once` computes each derived scalar
        once for the tensors ``lr`` and ``t`` it was given (the Trainer's
        fused update over many parameters)."""
        self._memo = {}
        try:
            yield
        finally:
            self._memo = None

    def _once(self, name, make, *scalars):
        """``make()``, or inside :meth:`scalar_memo` the value it gave for
        the same ``name`` and the same ``scalars`` objects (alive for the
        whole scope, so their ids stay unique)."""
        if self._memo is None:
            return make()
        key = (name,) + tuple(id(s) for s in scalars)
        got = self._memo.get(key)
        if got is None:
            got = self._memo[key] = make()
        return got

    # -- scheduling ---------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is "
                             "set")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _mult(self, table, attr, index):
        param = self.param_dict.get(index)
        if param is not None and getattr(param, attr, None) is not None:
            return getattr(param, attr)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def lr_mult_of(self, index) -> float:
        return self._mult(self.lr_mult, "lr_mult", index)

    def _get_lr(self, index) -> float:
        return self.learning_rate * self.lr_mult_of(index)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(self.wd_mult, "wd_mult", index)

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight) -> Tuple:
        return ()

    def create_state_multi_precision(self, index, weight):
        """A float32 master copy and the state made for it, for a float16
        or bfloat16 weight under ``multi_precision``; else
        :meth:`create_state`."""
        if self.multi_precision and weight.dtype in _HALF:
            master = weight.detach().to(torch.float32, copy=True)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- the rule (override me) ---------------------------------------------
    def update_step(self, weight, grad, state: Tuple, lr, wd, t: int):
        """Update ``weight`` and ``state`` in place from the scaled and
        clipped ``grad`` (the optimizer's own tensor)."""
        raise NotImplementedError

    def apply(self, weight, grad, state, lr, wd, t):
        """One rule application in place: on the master of a
        multi-precision state (the gradient in float32), the weight then
        set to the master rounded to its dtype; else on the weight."""
        if (self.multi_precision and weight.dtype in _HALF
                and is_master_state(state)):
            master, inner = state
            self.update_step(master, grad.to(torch.float32), inner, lr, wd,
                             t)
            weight.copy_(master)
        else:
            self.update_step(weight, grad, state, lr, wd, t)

    def _zeros(self, weight, n=1):
        return tuple(torch.zeros_like(
            weight, memory_format=torch.contiguous_format) for _ in range(n))

    # -- imperative API (the reference's signature) -------------------------
    def update(self, index, weight, grad, state):
        """One parameter's update in place (``weight`` a tensor or an
        ``nn.Parameter``), or several given as lists. The gradient is
        scaled and clipped in its own dtype, as the reference's
        imperative update does."""
        many = isinstance(index, (list, tuple))
        for i, w, g, s in zip(index if many else [index],
                              weight if many else [weight],
                              grad if many else [grad],
                              state if many else [state]):
            self._update_count(i)
            lr, wd = self._get_lr(i), self._get_wd(i)
            with torch.no_grad():
                g = g * self.rescale_grad
                if self.clip_gradient is not None:
                    g = g.clamp(-self.clip_gradient, self.clip_gradient)
                self.apply(w, g, s, lr, wd, self._index_update_count[i])

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


# ---------------------------------------------------------------------------
# SGD family
# ---------------------------------------------------------------------------
@register
class SGD(Optimizer):
    """SGD with momentum and weight decay:
    ``mom = momentum * mom - lr * (g + wd * w); w += mom``.
    ``lazy_update`` changes only what a row-sparse gradient does; the port
    has none, and dense gradients take the dense rule."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else self._zeros(weight)

    def update_step(self, w, g, state, lr, wd, t):
        if wd:
            g = g + wd * w
        if self.momentum == 0.0:
            w.sub_(lr * g)
            return
        (mom,) = state
        mom.mul_(self.momentum).sub_(lr * g)
        w.add_(mom)


sgd = SGD


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD: ``mom = momentum * mom + g;
    w -= lr * (g + momentum * mom)``."""

    def __init__(self, learning_rate=0.1, momentum=0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return self._zeros(weight)

    def update_step(self, w, g, state, lr, wd, t):
        if wd:
            g = g + wd * w
        (mom,) = state
        mom.mul_(self.momentum).add_(g)
        w.sub_(lr * (g + self.momentum * mom))


@register
class Signum(Optimizer):
    """signSGD / Signum: the weight moves by ``lr`` times the sign of the
    momentum (of the gradient when ``momentum`` is 0), after a decoupled
    ``wd_lh`` decay."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else self._zeros(weight)

    def update_step(self, w, g, state, lr, wd, t):
        g = g + wd * w
        keep = self._once("signum_decay", lambda: 1 - lr * self.wd_lh, lr)
        if self.momentum == 0.0:
            w.mul_(keep).sub_(lr * torch.sign(g))
            return
        (mom,) = state
        mom.mul_(self.momentum).sub_((1 - self.momentum) * g)
        w.mul_(keep).add_(lr * torch.sign(mom))


signsgd = Signum


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics:
    ``w += -lr / 2 * (g + wd * w) + sqrt(lr) * noise``, fresh standard
    normal noise per update from :meth:`draw_noise`."""

    fusable = False

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def draw_noise(self, weight):
        """The update's noise: float32 standard normals in the weight's
        shape from the port's generator of its device
        (``ops.nn.generator``), in the weight's dtype. The reference draws
        from threefry, which no torch generator reproduces: a caller that
        needs its draws replaces this method."""
        return torch.randn(weight.shape, generator=generator(weight.device),
                           device=weight.device).to(weight.dtype)

    def update_step(self, w, g, state, lr, wd, t):
        if wd:
            g = g + wd * w
        noise = self.draw_noise(w)
        w.sub_(lr / 2 * g).add_(math.sqrt(lr) * noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD: the gradient is compensated by
    ``lamda * g * g * (w - w_prev)``; the state keeps the momentum and the
    previous weight."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (self._zeros(weight)[0],
                weight.detach().clone(memory_format=torch.contiguous_format))

    def update_step(self, w, g, state, lr, wd, t):
        mom, prev_w = state
        if wd:
            g = g + wd * w
        mom.mul_(self.momentum).sub_(
            lr * (g + self.lamda * g * g * (w - prev_w)))
        w.add_(mom)
        prev_w.copy_(w)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the step is scaled per tensor by
    ``eta * |w| / (|g| + wd * |w| + eps)`` (1 where either norm is 0; the
    norms summed in float64)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return self._zeros(weight)

    def update_step(self, w, g, state, lr, wd, t):
        (mom,) = state
        w_norm, g_norm = _norm(w), _norm(g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            1.0)
        if wd:
            g = g + wd * w
        mom.mul_(self.momentum).add_(trust * lr * g)
        w.sub_(mom)


# ---------------------------------------------------------------------------
# adaptive family
# ---------------------------------------------------------------------------
@register
class Adam(Optimizer):
    """Adam: ``w -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``
    with weight decay added to the gradient (no bias correction when
    ``correct_bias`` is False). ``lazy_update`` as in :class:`SGD`."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return self._zeros(weight, 2)

    def _moments(self, g, state):
        m, v = state
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g.square())
        return m, v

    def _corrected(self, lr, t):
        return self._once("adam_lr", lambda: lr * _sqrt(
            1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t), lr, t)

    def update_step(self, w, g, state, lr, wd, t):
        if wd:
            g = g + wd * w
        m, v = self._moments(g, state)
        if self.correct_bias:
            lr = self._corrected(lr, t)
        w.sub_(lr * m / (v.sqrt() + self.epsilon))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: ``w -= lr_t * m / (sqrt(v) + eps)
    + lr * wd * w`` (always bias-corrected, as the reference's)."""

    def update_step(self, w, g, state, lr, wd, t):
        m, v = self._moments(g, state)
        decay = lr * wd * w
        w.sub_(self._corrected(lr, t) * m / (v.sqrt() + self.epsilon)
               ).sub_(decay)


@register
class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(b2 * u, |g|)``,
    ``w -= lr / (1 - b1^t) * m / (u + eps)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return self._zeros(weight, 2)

    def update_step(self, w, g, state, lr, wd, t):
        m, u = state
        if wd:
            g = g + wd * w
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        torch.maximum(self.beta2 * u, g.abs(), out=u)
        step = self._once("adamax_lr", lambda: lr / (1 - self.beta1 ** t),
                          lr, t)
        w.sub_(step * m / (u + self.epsilon))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum. ``m_schedule`` lives on the optimizer
    and advances once per parameter update, as in the reference."""

    fusable = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return self._zeros(weight, 2)

    def update_step(self, w, g, state, lr, wd, t):
        m, v = state
        if wd:
            g = g + wd * w
        b1, sd = self.beta1, self.schedule_decay
        momentum_t = b1 * (1.0 - 0.5 * 0.96 ** (t * sd))
        momentum_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * sd))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t1
        g_prime = g / (1.0 - self.m_schedule)
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(self.beta2).add_((1.0 - self.beta2) * g.square())
        m_prime = m / (1.0 - m_schedule_next)
        v_prime = v / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t1 * m_prime
        w.sub_(lr * m_bar / (v_prime.sqrt() + self.epsilon))


@register
class AdaGrad(Optimizer):
    """``h += g^2; w -= lr * g / (sqrt(h) + eps)``."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def create_state(self, index, weight):
        return (torch.full_like(weight, self.initial_accumulator_value,
                                memory_format=torch.contiguous_format),)

    def update_step(self, w, g, state, lr, wd, t):
        (hist,) = state
        if wd:
            g = g + wd * w
        hist.add_(g.square())
        w.sub_(lr * g / (hist.sqrt() + self.epsilon))


adagrad = AdaGrad


@register
class AdaDelta(Optimizer):
    """Running averages of ``g^2`` and of the squared step, ``rho``-
    weighted; the step is ``sqrt(acc_delta + eps) / sqrt(acc_g + eps) *
    g``."""

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return self._zeros(weight, 2)

    def update_step(self, w, g, state, lr, wd, t):
        acc_g, acc_delta = state
        if wd:
            g = g + wd * w
        acc_g.mul_(self.rho).add_((1 - self.rho) * g.square())
        delta = ((acc_delta + self.epsilon).sqrt()
                 / (acc_g + self.epsilon).sqrt() * g)
        acc_delta.mul_(self.rho).add_((1 - self.rho) * delta.square())
        w.sub_(lr * delta)


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered`` is Graves' variant with a mean of ``g`` and a
    momentum; ``clip_weights`` clamps the weight after the step."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return self._zeros(weight, 3 if self.centered else 1)

    def update_step(self, w, g, state, lr, wd, t):
        if wd:
            g = g + wd * w
        rho = self.rho
        if self.centered:
            n, gm, delta = state
            n.mul_(rho).add_((1 - rho) * g.square())
            gm.mul_(rho).add_((1 - rho) * g)
            delta.mul_(self.momentum).sub_(
                lr * g / (n - gm.square() + self.epsilon).sqrt())
            w.add_(delta)
        else:
            (n,) = state
            n.mul_(rho).add_((1 - rho) * g.square())
            w.sub_(lr * g / (n + self.epsilon).sqrt())
        if self.clip_weights:
            w.clamp_(-self.clip_weights, self.clip_weights)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (FTRL-proximal) with L1
    ``lamda1``; weight decay enters the denominator."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return self._zeros(weight, 2)

    def update_step(self, w, g, state, lr, wd, t):
        z, n = state
        sigma = ((n + g.square()).sqrt() - n.sqrt()) / lr
        z.add_(g).sub_(sigma * w)
        n.add_(g.square())
        w.copy_(torch.where(
            z.abs() > self.lamda1,
            -(z - torch.sign(z) * self.lamda1)
            / ((self.beta + n.sqrt()) / lr + wd), 0.0))


@register
class FTML(Optimizer):
    """Follow the moving leader; the state is ``(d, v, z)``."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return self._zeros(weight, 3)

    def update_step(self, w, g, state, lr, wd, t):
        prev_d, v, z = state
        if wd:
            g = g + wd * w
        b1 = self.beta1
        v.mul_(self.beta2).add_((1 - self.beta2) * g.square())
        c1 = self._once("ftml_c1", lambda: (1 - b1 ** t) / lr, lr, t)
        c2 = self._once("ftml_c2", lambda: 1 - self.beta2 ** t, t)
        d = c1 * ((v / c2).sqrt() + self.epsilon)
        sigma = d - b1 * prev_d
        z.mul_(b1).add_((1 - b1) * g).sub_(sigma * w)
        w.copy_(-z / d)
        prev_d.copy_(d)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments: Adam's direction plus ``wd * w``,
    scaled per tensor by ``|w| / |r|`` (``|w|`` clamped to
    ``lower_bound``/``upper_bound``; 1 where either norm is 0; the norms
    summed in float64)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return self._zeros(weight, 2)

    def update_step(self, w, g, state, lr, wd, t):
        m, v = state
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g.square())
        if self.bias_correction:
            m_hat = m / self._once("lamb_c1", lambda: 1 - self.beta1 ** t, t)
            v_hat = v / self._once("lamb_c2", lambda: 1 - self.beta2 ** t, t)
        else:
            m_hat, v_hat = m, v
        r = m_hat / (v_hat.sqrt() + self.epsilon) + wd * w
        w_norm = _norm(w)
        if self.lower_bound is not None:
            w_norm = w_norm.clamp(min=self.lower_bound)
        if self.upper_bound is not None:
            w_norm = w_norm.clamp(max=self.upper_bound)
        r_norm = _norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        w.sub_(lr * ratio * r)


lamb = LAMB


@register
class GroupAdaGrad(Optimizer):
    """Row-wise AdaGrad: one adaptive rate per row of a weight of two or
    more dimensions (state ``(rows, 1)``); no weight decay."""

    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kwargs):
        kwargs.pop("use_fused_step", None)
        super().__init__(learning_rate=learning_rate, **kwargs)
        if self.wd != 0.0:
            raise MXNetError("GroupAdaGrad does not support weight decay")
        self.epsilon = epsilon
        self.lazy_update = True

    def create_state(self, index, weight):
        if weight.dim() < 2:
            raise MXNetError("GroupAdaGrad requires >=2-D weights (rows)")
        return (torch.zeros((weight.shape[0], 1), dtype=weight.dtype,
                            device=weight.device),)

    def update_step(self, w, g, state, lr, wd, t):
        (hist,) = state
        hist.add_(g.square().mean(dim=tuple(range(1, g.dim())),
                                  keepdim=True).reshape(hist.shape))
        w.sub_(lr * g / (hist.sqrt() + self.epsilon))


group_adagrad = GroupAdaGrad


# ---------------------------------------------------------------------------
# host state blobs
# ---------------------------------------------------------------------------
def to_host(x):
    """A state tree with every tensor as a host numpy array (bfloat16
    widened exactly to float32: numpy has no bfloat16 of its own)."""
    if isinstance(x, (tuple, list)):
        return tuple(to_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy().copy()
    return x


def _tensor(a, device, dtype):
    a = onp.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16 from JAX
        a = a.astype(onp.float32)
    return torch.as_tensor(a).to(device=device, dtype=dtype, copy=True)


def _master_pair(state, weight):
    """A host multi-precision entry's ``(master, inner)``: the inner state
    is a tuple (the Trainer's layout) or one array stacking it (the
    Updater's: ``(k, *weight.shape)``, or ``(0,)`` for no state)."""
    if not isinstance(state, (tuple, list)) or len(state) != 2:
        return None
    master, inner = state
    if isinstance(inner, (tuple, list)) or (
            onp.asarray(inner).shape != tuple(weight.shape)):
        return master, tuple(inner)
    return None


def _on_host(state):
    if isinstance(state, (tuple, list)):
        return any(_on_host(s) for s in state)
    return isinstance(state, onp.ndarray)


def to_device(state, weight, optimizer):
    """A host state tree (a blob or ``.states`` file's) as the state of
    ``weight``: on its device, a multi-precision pair's master and inner
    state in float32, any other state in the weight's dtype. A tree of
    tensors is returned as it is."""
    if not _on_host(state):
        return state
    dev = weight.device
    pair = (_master_pair(state, weight) if optimizer.multi_precision
            and weight.dtype in _HALF else None)
    if pair is not None:
        master, inner = pair
        return (_tensor(master, dev, torch.float32),
                tuple(_tensor(s, dev, torch.float32) for s in inner))
    if isinstance(state, (tuple, list)):
        return tuple(to_device(s, weight, optimizer) for s in state)
    return _tensor(state, dev, weight.dtype)


def _stacked(v):
    """The reference Updater's host layout of one state entry: each
    member as an array, a tuple member (a master's inner state) stacked
    (``numpy.asarray`` of the tuple)."""
    if isinstance(v, tuple):
        return onp.asarray(tuple(_stacked(x) for x in v))
    return to_host(v)


class Updater:
    """``updater(index, grad, weight)``: creates the parameter's state on
    first use (``create_state_multi_precision``) and applies the
    optimizer's :meth:`~Optimizer.update` to it."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}

    def __call__(self, index, grad, weight):
        opt = self.optimizer
        if index not in self.states:
            self.states[index] = opt.create_state_multi_precision(index,
                                                                  weight)
        else:
            self.states[index] = to_device(self.states[index], weight, opt)
        opt.update(index, weight, grad, self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states pickled as host numpy arrays, in the reference's
        layout: ``{index: tuple of arrays}``, a multi-precision entry as
        ``(master, inner states stacked)``."""
        return pickle.dumps({
            k: tuple(_stacked(s) for s in v) if isinstance(v, tuple) else v
            for k, v in self.states.items()})

    def set_states(self, states):
        """Load :meth:`get_states`'s blob (of either package); the arrays
        move to each weight's device at its next update."""
        self.states = {k: tuple(v) if isinstance(v, (tuple, list)) else v
                       for k, v in pickle.loads(states).items()}


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)

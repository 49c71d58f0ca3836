"""Learning-rate schedulers of the PyTorch port (counterpart of
``mxnet_tpu/optimizer/lr_scheduler.py``), plain Python.

A scheduler is called with the optimizer's ``num_update`` and returns
the learning rate. As in the reference, ``FactorScheduler`` and
``MultiFactorScheduler`` keep their state on the object (``base_lr``
shrinks as ``num_update`` passes each step), ``PolyScheduler`` and
``CosineScheduler`` write the rate they return into ``base_lr``, and
warmup rises from ``warmup_begin_lr`` to ``warmup_final_lr``, which is
the ``base_lr`` the scheduler was built with (an optimizer's
``learning_rate`` overwrites ``base_lr`` only).
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base scheduler: the warmup of the first ``warmup_steps`` updates,
    ``linear`` from ``warmup_begin_lr`` or ``constant`` at it."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            increase = ((self.warmup_final_lr - self.warmup_begin_lr)
                        * float(num_update) / float(self.warmup_steps))
            return self.warmup_begin_lr + increase
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise ValueError(f"invalid warmup_mode {self.warmup_mode}")

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """``base_lr`` times ``factor`` each ``step`` updates, not below
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """``base_lr`` times ``factor`` once ``num_update`` passes each entry
    of the list ``step``."""

    def __init__(self, step, factor=1, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        assert isinstance(step, list) and len(step) >= 1
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """``final_lr + (base_lr - final_lr) * (1 - t / max_steps) ** pwr``
    after warmup, up to ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (
                self.base_lr_orig - self.final_lr) * pow(
                1 - float(num_update - self.warmup_steps)
                / float(self.max_steps), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Half a cosine from ``base_lr`` down to ``final_lr`` after warmup,
    up to ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (
                self.base_lr_orig - self.final_lr) * (1 + math.cos(
                    math.pi * (num_update - self.warmup_steps)
                    / self.max_steps)) / 2
        return self.base_lr

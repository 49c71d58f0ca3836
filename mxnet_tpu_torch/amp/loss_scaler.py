"""Dynamic loss scaling of the PyTorch port (the port's own copy of
``mxnet_tpu/amp/loss_scaler.py``): grow the scale every
``scale_window`` clean steps, halve it on overflow (not below
``min_scale``) and skip the update."""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0):
        self.loss_scale = float(init_scale)
        self._factor = scale_factor
        self._window = scale_window
        self._min = min_scale
        self._unskipped = 0

    def has_overflow(self, params) -> bool:
        """True if any gradient holds an inf or a NaN. The check is one
        fused pass (``torch._foreach_norm`` at order inf, which an inf
        or NaN entry carries through) and one host read a step, not one
        per parameter."""
        grads = []
        for p in params:
            g = getattr(p.data(), "grad", None) if hasattr(p, "data") else None
            if g is not None:
                grads.append(g)
        if not grads:
            return False
        dev = grads[0].device
        norms = torch._foreach_norm(grads, float("inf"))
        finite = torch.stack([n.to(dev) for n in norms]).isfinite().all()
        return not bool(finite)

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self._min, self.loss_scale / self._factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0

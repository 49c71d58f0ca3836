"""Weight-only int8 for the decode path of the PyTorch port (the
decode-time half of ``mxnet_tpu/contrib/quantization.py``).

:func:`quantize_weights_int8` stores every 2-D float parameter as int8
codes plus symmetric per-channel scales, and
:func:`dequantize_weights_int8` restores the original dtype; the serving
programs dequantize inside their step
(:func:`~mxnet_tpu_torch.gluon.model_zoo.generation.generate` and the
paged programs with ``weight_dtype="int8"``). The arithmetic is the
reference's, step for step, so codes and scales are bitwise equal to
the JAX package's for f32 and bf16 weights:

- the scales run along axis 1 (``channel_axis=1``): for a Dense weight
  ``(units, in_units)`` that is one scale per *input* column, shape
  ``(1, in_units)``; for an embedding ``(vocab, units)`` one per unit;
- ``amax / 127.0`` and ``w / scale`` are true divisions in float32 (the
  reference quantizes eagerly, outside any compiled program), a zero
  channel gets scale 1.0, and the scale is cast to the weight's dtype
  *before* the codes are computed;
- codes round half to even (``torch.round``, as ``rint``).

The reference's post-training quantization of whole networks
(``quantize_net``, the ``Quantized*`` blocks, calibration) waits for
ROADMAP section 1 item 10.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["quantize_weights_int8", "dequantize_weights_int8"]


def _sym_per_channel_int8(w, channel_axis=0, zero_scale=1e-8,
                          scale_dtype=None):
    """The symmetric per-channel int8 rule (reference
    ``quantization.py:133``): ``(codes int8, scale)``, the scale cast to
    ``scale_dtype`` before the codes are computed, so stored scale and
    codes always agree exactly."""
    axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    wf = w.to(torch.float32)
    scale = torch.amax(torch.abs(wf), dim=axes, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.full_like(scale, zero_scale),
                        scale)
    if scale_dtype is not None:
        scale = scale.to(scale_dtype)
    wq = torch.clamp(torch.round(wf / scale.to(torch.float32)),
                     -127, 127).to(torch.int8)
    return wq, scale


def quantize_weights_int8(params: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """Weight-only int8 of a name -> tensor dict (reference
    ``quantization.py:350``): every 2-D float tensor becomes int8 codes
    with a ``(1, shape[1])`` scale in its own dtype; everything else
    passes through as a copy, so the tree is a snapshot that an
    in-place update of the parameters (a Trainer step, ``set_data``)
    leaves alone, as a JAX tree is. Returns ``(qparams, scales)``."""
    qparams, scales = {}, {}
    with torch.no_grad():
        for k, v in params.items():
            v = v.detach()
            if v.ndim == 2 and v.is_floating_point():
                qparams[k], scales[k] = _sym_per_channel_int8(
                    v, channel_axis=1, zero_scale=1.0, scale_dtype=v.dtype)
            else:
                qparams[k] = v.clone()
    return qparams, scales


def dequantize_weights_int8(qparams: Dict[str, torch.Tensor],
                            scales: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_weights_int8`: int8 entries with a
    scale come back as ``q.to(s.dtype) * s``, in the original dtype. The
    product is one mixed-dtype multiply (torch promotes the int8 codes
    to the scale's dtype inside it, exactly, as |q| <= 127), so it reads
    the codes once and writes the result once, with no converted copy
    in between."""
    out = dict(qparams)
    for k, s in scales.items():
        out[k] = torch.mul(qparams[k], s)
    return out

"""Model passes behind ``HybridBlock.optimize_for(backend=...)``
(counterpart of ``mxnet_tpu/contrib/passes.py``).

A pass is ``fn(block) -> block`` over the Block tree (it may mutate
it); :func:`register_pass` names it, :func:`apply_pass` runs it by name
and :func:`list_passes` lists the names. ``fold_bn``
(:func:`fold_batch_norm`) folds each Conv/Dense + BatchNorm pair of a
``(Hybrid)Sequential`` into the layer's weight and bias, in float32
numpy as the reference computes it; ``default`` changes nothing.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["register_pass", "apply_pass", "list_passes", "fold_batch_norm"]

_PASSES: Dict[str, Callable] = {}


def register_pass(name: str, fn: Callable) -> None:
    """Register a model pass ``fn(block) -> block`` under ``name``
    (case-insensitive)."""
    _PASSES[name.lower()] = fn


def apply_pass(block, name: str):
    fn = _PASSES.get(name.lower())
    if fn is None:
        raise MXNetError(
            f"unknown optimize_for backend {name!r}; registered: "
            f"{sorted(_PASSES)}")
    return fn(block)


def list_passes():
    return sorted(_PASSES)


def _host(p):
    return p.data().detach().cpu().numpy()


def _fold_pair(layer, bn) -> bool:
    """Fold BatchNorm's affine transform into the layer before it, when
    the layer has no activation of its own, the BatchNorm normalizes
    axis 1 and both are initialized (reference ``passes.py:55``)."""
    from ..gluon.parameter import Parameter

    if getattr(layer, "act", None) is not None or bn._axis != 1:
        return False
    w = layer.weight
    if not w.initialized or not bn.gamma.initialized:
        return False
    gamma, beta = _host(bn.gamma), _host(bn.beta)
    mean, var = _host(bn.running_mean), _host(bn.running_var)
    scale = gamma / onp.sqrt(var + bn._epsilon)
    wv = _host(w)
    w.set_data(torch.from_numpy(wv * scale.reshape((-1,) + (1,) *
                                                   (wv.ndim - 1))))
    shift = (0.0 - mean) * scale + beta
    if layer.bias is not None:
        layer.bias.set_data(torch.from_numpy(
            (_host(layer.bias) - mean) * scale + beta))
    else:
        bias = Parameter("bias", shape=(wv.shape[0],), dtype=str(wv.dtype))
        bias.set_data(torch.from_numpy(shift), device=w.data().device)
        del layer.bias                  # the None kept by use_bias=False
        layer.bias = bias
    return True


def fold_batch_norm(block):
    """Fold Conv/Dense + BatchNorm pairs inside ``(Hybrid)Sequential``
    chains: each folded BatchNorm becomes ``Identity`` and its running
    statistics move into the layer's weight and bias, an inference-only
    rewrite (reference ``passes.py:94``). Returns the block; pairs that
    do not fold are left as they are."""
    from ..gluon import nn

    def walk(b):
        if isinstance(b, nn.Sequential):
            items = list(b._modules.items())
            for (_, cur), (cname, nxt) in zip(items, items[1:]):
                if (isinstance(cur, (nn.Conv1D, nn.Conv2D, nn.Conv3D,
                                     nn.Dense))
                        and isinstance(nxt, nn.BatchNorm)
                        and _fold_pair(cur, nxt)):
                    b._modules[cname] = nn.Identity()
        for child in b._modules.values():
            if child is not None:
                walk(child)
        return b

    out = walk(block)
    if hasattr(block, "hybridize") and getattr(block, "_active", False):
        block.hybridize(True)       # the folded weights: capture anew
    return out


register_pass("fold_bn", fold_batch_norm)
register_pass("default", lambda b: b)

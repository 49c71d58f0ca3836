"""Loss functions of the PyTorch port (counterpart of
``mxnet_tpu/gluon/loss.py``), limited to what the slices so far run:
``Loss``, ``L2Loss`` and ``SoftmaxCrossEntropyLoss``, as Gluon
HybridBlocks."""
from __future__ import annotations

from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_over_non_batch(loss):
    return loss.mean(dim=tuple(range(1, loss.dim()))) if loss.dim() > 1 \
        else loss


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    """weight/2 · (label - pred)², averaged over the non-batch axes
    (reference loss.py L2Loss); label is reshaped to pred's shape."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        if label.shape != pred.shape:
            label = label.reshape(pred.shape)
        loss = (label - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_over_non_batch(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy per batch row (sparse or dense labels),
    averaged over the non-batch axes.

    Sparse labels over logits on the last axis take the fused path:
    :func:`~..ops.nn.softmax_cross_entropy` (the K3 kernel on the card)
    on the flattened rows, with labels clipped into [0, V) and the NLL
    cast to pred's dtype, as the reference does."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis % pred.dim()
        if (self._sparse_label and not self._from_logits
                and axis == pred.dim() - 1):
            n_cls = pred.shape[-1]
            nll = F.softmax_cross_entropy(
                pred.reshape(-1, n_cls),
                label.reshape(-1).clamp(0, n_cls - 1), per_example=True)
            loss = nll.reshape(label.shape).to(pred.dtype)
            return _mean_over_non_batch(
                _apply_weighting(loss, self._weight, sample_weight))
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=axis)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=axis)
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))

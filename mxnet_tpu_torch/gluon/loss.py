"""Loss functions of the PyTorch port (counterpart of
``mxnet_tpu/gluon/loss.py``), as Gluon HybridBlocks: every loss of the
reference with its arithmetic written in torch, and its aliases
``SigmoidBCELoss`` and ``SoftmaxCELoss``.

Most losses average over the non-batch axes. ``SoftmaxCrossEntropyLoss``
with sparse labels over the last axis takes the K3 kernel on the card
(:func:`~..ops.nn.softmax_cross_entropy`); ``CTCLoss`` runs the
reference's forward recursion (not ``F.ctc_loss``).
"""
from __future__ import annotations

import math

import torch

from .. import numpy_extension as npx
from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "SDMLLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if label.shape != pred.shape else label


def _mean_over_non_batch(loss):
    return loss.mean(dim=tuple(range(1, loss.dim()))) if loss.dim() > 1 \
        else loss


def _softplus_minus(pred, label):
    """``log(1 + e^p) - p * l`` in the stable form
    ``max(p, 0) - p * l + log1p(e^-|p|)``."""
    return (pred.clamp(min=0) - pred * label
            + torch.log1p(torch.exp(-pred.abs())))


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    """weight/2 · (label - pred)², averaged over the non-batch axes; label
    is reshaped to pred's shape."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = (_reshape_like(pred, label) - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_over_non_batch(loss)


class L1Loss(Loss):
    """|label - pred|, averaged over the non-batch axes."""

    def forward(self, pred, label, sample_weight=None):
        loss = (_reshape_like(pred, label) - pred).abs()
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))


class HuberLoss(Loss):
    """|d| - rho/2 where |d| > rho, else d² / (2 rho)."""

    def __init__(self, rho=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = (_reshape_like(pred, label) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))


class HingeLoss(Loss):
    """max(margin - pred · label, 0) for labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = (self._margin - pred * _reshape_like(pred, label)).clamp(min=0)
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))


class SquaredHingeLoss(HingeLoss):
    """max(margin - pred · label, 0)²."""

    def forward(self, pred, label, sample_weight=None):
        loss = (self._margin - pred * _reshape_like(pred, label)
                ).clamp(min=0).square()
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))


class LogisticLoss(Loss):
    """log(1 + e^pred) - pred · label; ``label_format`` "signed" maps
    labels in {-1, 1} to {0, 1} first."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        return _mean_over_non_batch(_apply_weighting(
            _softplus_minus(pred, label), self._weight, sample_weight))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of sigmoid(pred) (of pred itself with
    ``from_sigmoid``), positives weighted by ``pos_weight``."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = _softplus_minus(pred, label)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    torch.log1p(torch.exp(-pred.abs()))
                    + (-pred).clamp(min=0))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy per batch row (sparse or dense labels),
    averaged over the non-batch axes.

    Sparse labels over logits on the last axis take the fused path:
    ``npx.softmax_cross_entropy`` (the K3 kernel on the card; float32
    logits under AMP, as the reference's) on the flattened rows, with labels clipped into [0, V) and the NLL
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
            nll = npx.softmax_cross_entropy(
                pred.reshape(-1, n_cls),
                label.reshape(-1).clamp(0, n_cls - 1), per_example=True)
            loss = nll.reshape(label.shape).to(pred.dtype)
            return _mean_over_non_batch(
                _apply_weighting(loss, self._weight, sample_weight))
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=axis)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=axis)
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label · (log(label) - pred), pred log-probabilities (log-softmax
    of pred when ``from_logits`` is False)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return _mean_over_non_batch(
            _apply_weighting(loss, self._weight, sample_weight))


class CTCLoss(Loss):
    """Connectionist temporal classification: the negative log-likelihood
    of each label sequence under the log-softmax of pred, by the forward
    recursion over time in log space (blank label 0; ``layout`` "NTC" or
    "TNC"; lengths default to the full sizes). The recursion runs in
    float64, as the reference's does with 64-bit types on."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        super().__init__(weight, 0)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "TNC":
            pred = pred.transpose(0, 1)
        n, steps, _ = pred.shape
        dev = pred.device
        if pred_lengths is None:
            pred_lengths = torch.full((n,), steps, dtype=torch.int32,
                                      device=dev)
        if label_lengths is None:
            label_lengths = torch.full((n,), label.shape[1],
                                       dtype=torch.int32, device=dev)
        loss = _ctc_nll(pred, label, pred_lengths.to(dev),
                        label_lengths.to(dev)).to(pred.dtype)
        return _apply_weighting(loss, self._weight, sample_weight)


def _ctc_nll(logits, labels, in_len, lab_len, blank=0, skip_blank=True):
    """The reference's forward recursion (``loss.py:243-281``): alpha over
    the label sequence with blanks between and around its labels. With
    ``skip_blank=False`` a label equal to the blank is never skipped to,
    as ``npx.ctc_loss`` (``numpy_extension/__init__.py:789``) rules."""
    logp = torch.log_softmax(logits, dim=-1).to(torch.float64)
    n, steps, _ = logp.shape
    s = 2 * labels.shape[1] + 1
    dev = logp.device
    ext = torch.full((n, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    neg_inf = torch.tensor(-1e30, dtype=torch.float64, device=dev)
    rows = torch.arange(n, device=dev)
    first = torch.where(lab_len > 0, logp[rows, 0, ext[:, 1]], neg_inf) \
        if s > 1 else None
    alpha = torch.cat([logp[:, 0, blank, None]]
                      + ([first[:, None]] if first is not None else [])
                      + [neg_inf.expand(n, max(s - 2, 0))], dim=1)
    same = torch.cat([torch.ones((n, min(s, 2)), dtype=torch.bool,
                                 device=dev), ext[:, 2:] == ext[:, :-2]],
                     dim=1)
    if not skip_blank:
        same = same | (ext == blank)
    pad1 = neg_inf.expand(n, 1)
    pad2 = neg_inf.expand(n, 2)
    for t in range(1, steps):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(same, neg_inf,
                             torch.cat([pad2, alpha[:, :-2]], dim=1)[:, :s])
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        new = merged + torch.gather(logp[:, t, :], 1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end = 2 * lab_len.long()
    last = torch.gather(alpha, 1, end[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (end - 1).clamp(min=0)[:, None])[:, 0]
    # an empty target: only the all-blank path counts, once
    last2 = torch.where(lab_len > 0, last2, neg_inf)
    return -torch.logaddexp(last, last2)


class TripletLoss(Loss):
    """max(|pos - pred|² - |neg - pred|² + margin, 0), the squares summed
    over the non-batch axes."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = ((positive - pred).square() - (negative - pred).square()).sum(
            dim=tuple(range(1, pred.dim())))
        loss = (loss + self._margin).clamp(min=0)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """exp(pred) - target · pred (pred - target · log(pred + eps) when
    not ``from_logits``), plus Stirling's term for targets above 1 with
    ``compute_full``; the mean over all elements."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * torch.log(target + epsilon) - target
                        + 0.5 * torch.log(2 * target * math.pi + epsilon))
            loss = loss + torch.where(target <= 1, 0.0, stirling)
        return _apply_weighting(loss, self._weight, sample_weight).mean()


class CosineEmbeddingLoss(Loss):
    """1 - cos(x1, x2) for label 1, max(cos - margin, 0) otherwise, the
    cosine along the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input2 = _reshape_like(input1, input2)
        cos = (input1 * input2).sum(dim=-1) / (
            torch.linalg.vector_norm(input1, dim=-1)
            * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1.0 - cos,
                           (cos - self._margin).clamp(min=0))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: each row of ``x2`` is the positive
    of the same row of ``x1`` and the rest of the batch its negatives; KL
    between the softmax of negative squared distances and the smoothed
    identity, times the batch size."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        batch_size = x1.shape[0]
        gold = torch.eye(batch_size, device=x1.device)
        p = self.smoothing_parameter
        labels = gold * (1 - p) + (1 - gold) * p / (batch_size - 1)
        distances = (x1[:, None] - x2[None]).pow(2).sum(dim=2)
        log_probabilities = npx.log_softmax(-distances, axis=1)
        return self.kl_loss(log_probabilities, labels) * batch_size

"""Evaluation metrics of the PyTorch port (counterpart of
``mxnet_tpu/gluon/metric.py``).

Each ``update(labels, preds)`` reduces every (label, pred) pair where
the tensors lie, on the card for CUDA tensors, to a few statistics
(counts, sums, a confusion matrix's entries), and brings them to the
host in one transfer for the whole update: no per-element work runs on
the host. Numpy arrays and lists are taken as CPU tensors. The custom
metric (``create(feval)``) hands its function numpy arrays, as the
reference does.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Fbeta", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "Perplexity", "PearsonCorrelation",
           "PCC", "Loss", "BinaryAccuracy", "MeanCosineSimilarity",
           "MeanPairwiseDistance", "Torch", "Caffe", "create", "register"]

_registry: Dict[str, type] = {}


def register(cls):
    _registry[cls.__name__.lower()] = cls
    return cls


def create(metric, *args, **kwargs):
    """A metric from an instance, a list (a composite of each), a
    function ``feval(label, pred)`` (the custom metric) or a registered
    name."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m))
        return composite
    if callable(metric):
        return _CustomMetric(metric)
    try:
        klass = _registry[metric.lower()]
    except KeyError:
        raise MXNetError(f"unknown metric {metric!r}; registered: "
                         f"{sorted(_registry)}") from None
    return klass(*args, **kwargs)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        onp.asarray(x))


def _fetch(stats):
    """The statistics of every pair of one update, reduced where they
    lie, as float64 rows on the host: the update's one transfer."""
    if not stats:
        return []
    dev = stats[0].device
    return torch.stack([s.to(dev) for s in stats]).cpu().numpy()


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        """Reduce each pair (:meth:`_stats`) and accumulate the rows
        (:meth:`_accumulate`) after one transfer."""
        pairs = []
        for l, p in zip(_as_list(labels), _as_list(preds)):
            p = _tensor(p)
            pairs.append((_tensor(l).to(p.device), p))
        rows = _fetch([self._stats(l, p) for l, p in pairs])
        for (l, p), row in zip(pairs, rows):
            self._accumulate(l, p, row)

    def _stats(self, label, pred):
        """One pair's statistics as a 1-D tensor on its device."""
        raise NotImplementedError

    def _accumulate(self, label, pred, row):
        """Default: ``row`` is (sum, instances)."""
        self.sum_metric += float(row[0])
        self.num_inst += int(row[1])

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _stat(*values):
    """Scalars and 0-dim tensors as one 1-D float64 tensor on the first
    tensor's device."""
    dev = next((v.device for v in values if isinstance(v, torch.Tensor)),
               None)
    return torch.stack([torch.as_tensor(v, dtype=torch.float64, device=dev)
                        for v in values])


class _CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, once per pair."""

    def __init__(self, feval, name=None):
        super().__init__(name or feval.__name__)
        self._feval = feval

    def update(self, labels, preds):
        for l, p in zip(_as_list(labels), _as_list(preds)):
            self.sum_metric += self._feval(_tensor(l).cpu().numpy(),
                                           _tensor(p).cpu().numpy())
            self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite"):
        super().__init__(name)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values


@register
class Accuracy(EvalMetric):
    """Top-1 classification accuracy: pred is argmax-ed along ``axis``
    when it has more dimensions than label."""

    def __init__(self, axis=1, name="accuracy", **kw):
        super().__init__(name, **kw)
        self.axis = axis

    def _stats(self, label, pred):
        if pred.dim() > label.dim():
            pred = pred.argmax(dim=self.axis)
        correct = (pred.to(torch.int64).reshape(-1)
                   == label.to(torch.int64).reshape(-1)).sum()
        return _stat(correct, label.numel())


acc = Accuracy
_registry["acc"] = Accuracy


@register
class TopKAccuracy(EvalMetric):
    """The share of rows whose label is among pred's ``top_k`` largest
    (ties in index order, as a stable sort)."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kw):
        super().__init__(f"{name}_{top_k}", **kw)
        self.top_k = top_k

    def _stats(self, label, pred):
        topk = torch.argsort(-pred, dim=-1, stable=True)[..., :self.top_k]
        hits = (topk == label.to(torch.int64)[..., None]).any(dim=-1)
        return _stat(hits.sum(), hits.numel())


def _confusion(label, pred):
    """[tp, fp, fn, tn] of a binary classification: pred's argmax over a
    last axis wider than 1, else pred > 0.5."""
    label = label.reshape(-1).to(torch.int64)
    if pred.dim() > 1 and pred.shape[-1] > 1:
        cls = pred.argmax(dim=-1)
    else:
        cls = pred.reshape(-1) > 0.5
    cls = cls.reshape(-1).to(torch.int64)
    return _stat(((cls == 1) & (label == 1)).sum(),
                 ((cls == 1) & (label == 0)).sum(),
                 ((cls == 0) & (label == 1)).sum(),
                 ((cls == 0) & (label == 0)).sum())


@register
class F1(EvalMetric):
    """F1 of the positive class over the counts of every update."""

    def __init__(self, name="f1", average="macro", **kw):
        self.average = average
        super().__init__(name, **kw)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def _stats(self, label, pred):
        return _confusion(label, pred)

    def _accumulate(self, label, pred, row):
        self._tp += float(row[0])
        self._fp += float(row[1])
        self._fn += float(row[2])
        self._tn += float(row[3])
        self.num_inst += 1

    def _prec_rec(self):
        prec = self._tp / max(self._tp + self._fp, 1e-12)
        rec = self._tp / max(self._tp + self._fn, 1e-12)
        return prec, rec

    def get(self):
        prec, rec = self._prec_rec()
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1 if self.num_inst else float("nan")


@register
class Fbeta(F1):
    """F-score with recall weighted ``beta``²."""

    def __init__(self, name="fbeta", beta=1.0, **kw):
        self.beta = float(beta)
        super().__init__(name, **kw)

    def get(self):
        prec, rec = self._prec_rec()
        b2 = self.beta * self.beta
        fbeta = ((1 + b2) * prec * rec) / max(b2 * prec + rec, 1e-12)
        return self.name, fbeta if self.num_inst else float("nan")


@register
class MCC(F1):
    """Matthews correlation coefficient over the counts of every
    update."""

    def __init__(self, name="mcc", **kw):
        super().__init__(name, **kw)

    def get(self):
        tp, fp, fn, tn = self._tp, self._fp, self._fn, self._tn
        denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        mcc = (tp * tn - fp * fn) / denom if denom else 0.0
        return self.name, mcc if self.num_inst else float("nan")


@register
class MAE(EvalMetric):
    """Mean absolute error, averaged over the updates' pairs."""

    def __init__(self, name="mae", **kw):
        super().__init__(name, **kw)

    def _stats(self, label, pred):
        return _stat((label - pred.reshape(label.shape)).abs().mean(), 1)


@register
class MSE(EvalMetric):
    """Mean squared error, averaged over the updates' pairs."""

    def __init__(self, name="mse", **kw):
        super().__init__(name, **kw)

    def _stats(self, label, pred):
        return _stat((label - pred.reshape(label.shape)).square().mean(), 1)


@register
class RMSE(MSE):
    """The square root of :class:`MSE`'s value."""

    def __init__(self, name="rmse", **kw):
        EvalMetric.__init__(self, name, **kw)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(self.sum_metric / self.num_inst)


@register
class CrossEntropy(EvalMetric):
    """Mean of -log(pred[label] + eps) over rows, pred probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kw):
        super().__init__(name, **kw)
        self.eps = eps

    def _stats(self, label, pred):
        label = label.reshape(-1).to(torch.int64)
        prob = pred[torch.arange(label.shape[0], device=pred.device), label]
        return _stat((-torch.log(prob + self.eps)).sum(), label.shape[0])


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kw):
        CrossEntropy.__init__(self, eps, name, **kw)


@register
class Perplexity(CrossEntropy):
    """exp of :class:`CrossEntropy`'s value (``ignore_label`` and ``axis``
    are accepted and, as in the reference, not used)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kw):
        CrossEntropy.__init__(self, 1e-12, name, **kw)
        self.ignore_label = ignore_label

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@register
class PearsonCorrelation(EvalMetric):
    """Pearson's r of all labels against all preds seen, from running
    float64 sums (n, Σl, Σp, Σl², Σp², Σlp)."""

    def __init__(self, name="pearsonr", **kw):
        super().__init__(name, **kw)

    def reset(self):
        super().reset()
        self._sums = onp.zeros(6)

    def _stats(self, label, pred):
        l = label.reshape(-1).to(torch.float64)
        p = pred.reshape(-1).to(torch.float64)
        return _stat(l.numel(), l.sum(), p.sum(), (l * l).sum(),
                     (p * p).sum(), (l * p).sum())

    def _accumulate(self, label, pred, row):
        self._sums += row
        self.num_inst += 1

    def get(self):
        n, sl, sp, sll, spp, slp = self._sums
        if not n:
            return self.name, float("nan")
        cov = slp - sl * sp / n
        return self.name, float(cov / math.sqrt((sll - sl * sl / n)
                                                * (spp - sp * sp / n)))


@register
class Loss(EvalMetric):
    """Mean of the loss values given as preds (labels unused)."""

    def __init__(self, name="loss", **kw):
        super().__init__(name, **kw)

    def update(self, _, preds):
        preds = [_tensor(p) for p in _as_list(preds)]
        for p, row in zip(preds, _fetch([p.sum(dtype=torch.float64)[None]
                                         for p in preds])):
            self.sum_metric += float(row[0])
            self.num_inst += p.numel()


@register
class BinaryAccuracy(EvalMetric):
    """Accuracy of pred > ``threshold`` against binary labels."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kw):
        self.threshold = threshold
        super().__init__(name, **kw)

    def _stats(self, label, pred):
        hit = ((pred.reshape(-1) > self.threshold).to(torch.int64)
               == label.reshape(-1).to(torch.int64))
        return _stat(hit.sum(), label.numel())


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis."""

    def __init__(self, name="cos_sim", eps=1e-12, **kw):
        self.eps = eps
        super().__init__(name, **kw)

    def _stats(self, label, pred):
        if label.dim() == 1:
            label, pred = label[None], pred[None]
        num = (label * pred).sum(dim=-1)
        den = (torch.linalg.vector_norm(label, dim=-1)
               * torch.linalg.vector_norm(pred, dim=-1))
        sim = num / den.clamp(min=self.eps)
        return _stat(sim.sum(), sim.numel())


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean L-``p`` distance along the last axis."""

    def __init__(self, name="mpd", p=2, **kw):
        self.p = p
        super().__init__(name, **kw)

    def _stats(self, label, pred):
        if label.dim() == 1:
            label, pred = label[None], pred[None]
        d = ((label - pred).abs() ** self.p).sum(dim=-1) ** (1.0 / self.p)
        return _stat(d.sum(), d.numel())


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation from a running confusion matrix
    (rows pred, columns label), grown as larger classes appear; equals
    MCC for two classes. An update transfers its pairs' distinct (pred,
    label) codes and their counts."""

    _SHIFT = 1 << 31

    def __init__(self, name="pcc", **kw):
        self.k = 2
        super().__init__(name, **kw)

    def reset(self):
        self.lcm = onp.zeros((getattr(self, "k", 2),) * 2, dtype="float64")
        super().reset()

    def update(self, labels, preds):
        codes = []
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _tensor(label), _tensor(pred)
            label = label.reshape(-1).to(torch.int64)
            if pred.dim() > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(dim=-1)
            else:
                pred = pred.reshape(-1) > 0.5
            codes.append(pred.reshape(-1).to(torch.int64) * self._SHIFT
                         + label.to(pred.device))
        if codes:
            dev = codes[0].device
            uniq, counts = torch.unique(
                torch.cat([c.to(dev) for c in codes]), return_counts=True)
            host = torch.stack([uniq, counts]).cpu().numpy()
            pred_cls, label_cls = host[0] // self._SHIFT, host[0] % \
                self._SHIFT
            n = int(max(pred_cls.max(initial=0), label_cls.max(initial=0)))
            if n >= self.k:
                self.lcm = onp.pad(self.lcm, ((0, n + 1 - self.k),) * 2)
                self.k = n + 1
            onp.add.at(self.lcm, (pred_cls, label_cls), host[1])
        self.num_inst += 1

    def get(self):
        cmat = self.lcm
        n = cmat.sum()
        if not n or not self.num_inst:
            return self.name, float("nan")
        x = cmat.sum(axis=1)
        y = cmat.sum(axis=0)
        cov_xx = onp.sum(x * (n - x))
        cov_yy = onp.sum(y * (n - y))
        if cov_xx == 0 or cov_yy == 0:
            return self.name, float("nan")
        i = cmat[onp.arange(self.k), onp.arange(self.k)]
        cov_xy = onp.sum(i * n - x * y)
        return self.name, float(cov_xy / (cov_xx * cov_yy) ** 0.5)


# the reference's aliases: Torch and Caffe are Loss under other names
Torch = Loss
Caffe = Loss

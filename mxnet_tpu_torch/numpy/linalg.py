"""``mx.np.linalg`` of the PyTorch port (counterpart of
``mxnet_tpu/numpy/linalg.py``), on ``torch.linalg`` (cuSOLVER and cuBLAS
on the card). An integer input is taken in float64 (64-bit) or float32,
as the reference takes it.

``lstsq`` is solved by SVD with ``rcond``, returning the rank and the
singular values, as ``jnp.linalg.lstsq`` does: ``torch.linalg.lstsq``
on the card has only the ``gels`` driver, which assumes full rank.
``svd``, ``eig``, ``eigh`` and ``qr`` vectors are defined up to sign (or
phase): compare reconstructions, not vectors.
"""
from __future__ import annotations

import torch

from ..ops import dispatch as _dispatch
from . import _inexact, _tt

__all__ = ["norm", "inv", "pinv", "det", "slogdet", "matrix_rank",
           "matrix_power", "cholesky", "qr", "svd", "eig", "eigh", "eigvals",
           "eigvalsh", "solve", "lstsq", "tensorinv", "tensorsolve",
           "multi_dot", "cond"]


def _f(a):
    return _inexact(_tt(a))


def norm(x, ord=None, axis=None, keepdims=False):
    """numpy's norm: the 2-norm of the flattened array with no ``ord``
    and no ``axis``, a vector norm over one axis, a matrix norm over
    two."""
    x = _f(x)
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("norm", x)
    if axis is None and ord is None:
        out = torch.linalg.vector_norm(x)
        return out.reshape((1,) * x.dim()) if keepdims else out
    if axis is None:
        axis = tuple(range(x.dim()))
    return torch.linalg.norm(x, ord, dim=axis, keepdim=keepdims)


def inv(a):
    return torch.linalg.inv(_f(a))


def pinv(a, rcond=1e-15):
    """Pseudo-inverse; singular values below ``rcond`` times the largest
    are dropped (the reference passes 1e-15)."""
    return torch.linalg.pinv(_f(a), rtol=rcond)


def det(a):
    return torch.linalg.det(_f(a))


def slogdet(a):
    sign, logabs = torch.linalg.slogdet(_f(a))
    return sign, logabs


def matrix_rank(a, tol=None):
    """The count of singular values above ``tol`` (by default the
    largest times ``max(M, N) * eps``), int64."""
    a = _f(a)
    if tol is None:
        return torch.linalg.matrix_rank(a)
    s = torch.linalg.svdvals(a)
    return (s > tol).sum(-1)


def matrix_power(a, n):
    return torch.linalg.matrix_power(_tt(a), n)


def cholesky(a, upper=False):
    L = torch.linalg.cholesky(_f(a))
    return L.transpose(-2, -1) if upper else L


def qr(a, mode="reduced"):
    q, r = torch.linalg.qr(_f(a), mode=mode)
    return q, r


def svd(a, full_matrices=False, compute_uv=True):
    """(U, S, Vh), reduced unless ``full_matrices`` (the reference's
    default is reduced); the singular values alone without
    ``compute_uv``."""
    a = _f(a)
    if not compute_uv:
        return torch.linalg.svdvals(a)
    u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
    return u, s, vh


def eig(a):
    w, v = torch.linalg.eig(_f(a))
    return w, v


def eigh(a, UPLO="L"):
    w, v = torch.linalg.eigh(_f(a), UPLO=UPLO)
    return w, v


def eigvals(a):
    return torch.linalg.eigvals(_f(a))


def eigvalsh(a, UPLO="L"):
    return torch.linalg.eigvalsh(_f(a), UPLO=UPLO)


def _promote(a, b):
    a, b = _f(a), _f(_tt(b, a))
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def solve(a, b):
    """x with a @ x = b. ``b`` is a vector only when 1-D, as in numpy 2
    (torch would take a (..., M) ``b`` of one dimension fewer than ``a``
    as a batch of vectors)."""
    a, b = _promote(a, b)
    if b.dim() == 1:
        return torch.linalg.solve(a, b[:, None])[..., 0] if a.dim() == 2 \
            else torch.linalg.solve(a, b.expand(a.shape[:-1])[..., None]
                                    )[..., 0]
    if b.dim() == a.dim() - 1:
        b = b[None]
    return torch.linalg.solve(a, b)


def lstsq(a, b, rcond="warn"):
    """(x, residuals, rank, s) by SVD, as ``jnp.linalg.lstsq``: singular
    values below ``rcond`` times the largest (``eps * max(M, N)`` by
    default) are dropped; the residuals are the squared norms of
    ``b - a @ x`` per column, always (shape (1,) for a vector ``b``)."""
    a, b = _promote(a, b)
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond == "warn" or rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    x = vh.conj().T @ (s_inv * (u.conj().T @ b))
    resid = torch.linalg.vector_norm(b - a @ x, dim=0) ** 2
    if vec:
        x = x.reshape(-1)
    return x, resid, rank, s


def tensorinv(a, ind=2):
    """The inverse of ``a`` taken as a matrix of its first ``ind`` axes by
    the rest."""
    a = _f(a)
    rows = a.shape[:ind]
    cols = a.shape[ind:]
    n = 1
    for d in rows:
        n *= d
    return torch.linalg.inv(a.reshape(n, -1)).reshape(tuple(cols)
                                                      + tuple(rows))


def tensorsolve(a, b, axes=None):
    """x with ``tensordot(a, x, x.ndim) == b``; ``axes`` of ``a`` move to
    the end first."""
    a, b = _promote(a, b)
    if axes is not None:
        rest = [d for d in range(a.dim()) if d not in
                [x % a.dim() for x in axes]]
        a = a.permute(*rest, *[x % a.dim() for x in axes])
    xshape = a.shape[b.dim():]
    n = b.numel()
    return torch.linalg.solve(a.reshape(n, -1), b.reshape(n)).reshape(
        xshape)


def multi_dot(arrays):
    ts = [_tt(a) for a in arrays]
    return torch.linalg.multi_dot(ts)


def cond(x, p=None):
    return torch.linalg.cond(_f(x), p)

"""``mx.nd`` of the PyTorch port: the array is ``torch.Tensor``; the
reference's array methods are functions (:mod:`.ndarray`).

As in the reference (``mxnet_tpu/ndarray/__init__.py``), every ``mx.np``
name is reachable as ``mx.nd.<name>`` (``mx.nd.zeros``, ``mx.nd.dot``),
and ``mx.nd.array`` makes an array of host data. ``Custom`` waits for
``operator.py`` (``ROADMAP.md`` §1 item 11) and the sparse names for
``ndarray/sparse.py`` (item 3): each raises :class:`MXNetError` naming its
item instead of falling through to ``mx.np``.
"""
from ..base import MXNetError
from .ndarray import (NDArray, as_in_context, as_in_ctx, asnumpy,
                      attach_grad, copyto, from_numpy, ndarray,
                      wait_to_read, waitall)

__all__ = ["ndarray", "NDArray", "array", "from_numpy", "asnumpy",
           "attach_grad", "as_in_ctx", "as_in_context", "copyto",
           "wait_to_read", "waitall", "Custom", "CSRNDArray",
           "RowSparseNDArray", "cast_storage", "csr_matrix",
           "row_sparse_array"]


def array(obj, dtype=None, ctx=None, device=None):
    """An array of ``obj`` on ``device`` (the reference's
    ``mx.nd.array``), through ``mx.np.array``."""
    from ..numpy import array as _array

    return _array(obj, dtype=dtype, ctx=ctx, device=device)


def _waits(name, item, module):
    def raises(*args, **kwargs):
        raise MXNetError(
            f"mx.nd.{name} is not ported yet: it waits for {module} "
            f"(ROADMAP.md §1 item {item})")
    raises.__name__ = raises.__qualname__ = name
    return raises


Custom = _waits("Custom", 11, "operator.py")
CSRNDArray = _waits("CSRNDArray", 3, "ndarray/sparse.py")
RowSparseNDArray = _waits("RowSparseNDArray", 3, "ndarray/sparse.py")
cast_storage = _waits("cast_storage", 3, "ndarray/sparse.py")
csr_matrix = _waits("csr_matrix", 3, "ndarray/sparse.py")
row_sparse_array = _waits("row_sparse_array", 3, "ndarray/sparse.py")


def __getattr__(name):
    # the legacy surface: any mx.np name is reachable as mx.nd.<name>
    from .. import numpy as _np

    try:
        return getattr(_np, name)
    except AttributeError:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.ndarray' has no attribute "
            f"{name!r}") from None

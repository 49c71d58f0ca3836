"""``mx.nd`` of the PyTorch port: the array is ``torch.Tensor``; the
reference's array methods are functions (:mod:`.ndarray`)."""
from .ndarray import (NDArray, as_in_context, as_in_ctx, asnumpy,
                      attach_grad, copyto, from_numpy, ndarray,
                      wait_to_read, waitall)

__all__ = ["ndarray", "NDArray", "from_numpy", "asnumpy", "attach_grad",
           "as_in_ctx", "as_in_context", "copyto", "wait_to_read",
           "waitall"]

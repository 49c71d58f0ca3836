"""``mx.rtc`` of the PyTorch port on the CPU: ``TorchModule`` (plain
torch source, differentiable) against the JAX package's ``XLAModule``,
the C signature parser of ``CudaModule.get_kernel``, and the error
paths. ``CudaModule`` compiles with NVRTC and launches only on the
card; here it must refuse, not fall back (``chip_smoke.py`` compiles and
checks two user kernels on the H100).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu_torch import autograd, rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import attach_grad

JAX_SRC = r"""
def gelu_ish(x):
    return x * jax.nn.sigmoid(1.702 * x)
"""
TORCH_SRC = r"""
def gelu_ish(x):
    return x * torch.sigmoid(1.702 * x)

def scale_rows(x, s):
    return x * s[:, None]
"""


def test_torch_module_matches_xla_module_with_gradients():
    """The same function as JAX XLAModule source and as TorchModule
    source: values and d(sum)/dx within 1e-6 (f32, a few ops)."""
    xv = onp.linspace(-2, 2, 9).astype(onp.float32)
    jk = jmx.rtc.XLAModule(JAX_SRC, exports=["gelu_ish"]).get_kernel(
        "gelu_ish")
    jx = jmx.np.array(xv)
    jx.attach_grad()
    with jautograd.record():
        jy = jk.launch([jx], out_shapes=[(9,)])
        loss = jy.sum()
    loss.backward()
    tk = rtc.TorchModule(TORCH_SRC, exports=["gelu_ish"]).get_kernel(
        "gelu_ish", "const float *x, float *y")
    tx = torch.from_numpy(xv.copy())
    attach_grad(tx)
    with autograd.record():
        ty = tk.launch([tx], out_shapes=[(9,)])
    autograd.backward(ty.sum())
    onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(),
                                rtol=1e-6, atol=1e-7)
    onp.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                rtol=1e-6, atol=1e-7)
    two = rtc.TorchModule(TORCH_SRC).get_kernel("scale_rows")
    out = two.launch([torch.ones(2, 3), torch.tensor([2.0, 3.0])])
    assert out.tolist() == [[2.0] * 3, [3.0] * 3]


@pytest.mark.parametrize("sig,want", [
    ("const float *x, const float *y, float *o",
     [("float", True, True), ("float", True, True), ("float", True, False)]),
    ("int n, const float* __restrict__ x, float* o",
     [("int", False, False), ("float", True, True),
      ("float", True, False)]),
    ("const __nv_bfloat16 *a, int64_t n, double alpha, unsigned char *m",
     [("__nv_bfloat16", True, True), ("int64_t", False, False),
      ("double", False, False), ("unsigned char", True, False)]),
    ("const float*, int", [("float", True, True), ("int", False, False)]),
])
def test_signature_parsing(sig, want):
    assert rtc.parse_signature(sig) == want


@pytest.mark.parametrize("sig", ["float **x", "struct S *s", "__half h",
                                 "float x,", "const float *x, , int n"])
def test_signature_parsing_refuses_what_it_cannot_marshal(sig):
    with pytest.raises(MXNetError):
        rtc.parse_signature(sig)


def test_export_and_missing_kernel_errors():
    """A kernel outside exports, a missing kernel, and source that does
    not compile raise MXNetError, as in the JAX package."""
    mod = rtc.TorchModule(TORCH_SRC, exports=["gelu_ish"])
    with pytest.raises(MXNetError, match="exports"):
        mod.get_kernel("scale_rows")
    with pytest.raises(MXNetError, match="no kernel"):
        mod.get_kernel("missing_kernel")
    with pytest.raises(MXNetError, match="compiling"):
        rtc.TorchModule("def broken(:\n")
    with pytest.raises(jmx.MXNetError):
        jmx.rtc.XLAModule(JAX_SRC, exports=["gelu_ish"]).get_kernel("nope")


def test_cuda_module_refuses_without_a_card(monkeypatch):
    """CudaModule raises on a machine without a card, and a kernel's
    launch raises on CPU tensors: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        rtc.CudaModule('extern "C" __global__ void k(float *x) {}')
    kernel = rtc.CudaKernel(None, "k", "k", rtc.parse_signature("float *x"))
    before = rtc.CudaKernel.launches
    with pytest.raises(MXNetError, match="CPU tensors"):
        kernel.launch([torch.zeros(4)])
    with pytest.raises(MXNetError, match="no tensor"):
        kernel.launch([3])
    assert rtc.CudaKernel.launches == before

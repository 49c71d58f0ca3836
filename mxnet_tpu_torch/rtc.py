"""``mx.rtc`` of the PyTorch port: kernels compiled at run time (kernel
R; counterpart of ``mxnet_tpu/rtc.py``).

The JAX package compiles user **Pallas** source (``PallasModule``; its
``Kernel.launch`` reaches ``pl.pallas_call``, ``rtc.py:57``). On the
card the user's language is CUDA C again, as in the reference MXNet:
:class:`CudaModule` (``CudaModule(source, options, exports)``, the
reference's own name and API) compiles the source with **NVRTC** for the
card's architecture (``sm_90a`` on an H100) and loads it with the CUDA
driver API, both through ctypes: ``libnvrtc.so`` from
``$CUDA_HOME/lib64`` (or torch's bundled copy) and ``libcuda.so.1``.
Kernels launch on torch's current stream, in torch's primary context.

:meth:`CudaModule.get_kernel` takes the kernel's C signature
(``"const float *x, const float *y, float *o, int n"``) to marshal
tensors as pointers and numbers as scalars. :meth:`CudaKernel.launch`
allocates the outputs given by ``out_shapes``/``out_dtypes`` and appends
them after the inputs, as Pallas appends output refs, or, with no
``out_shapes``, writes into the tensors it is given (the reference's
form). Compile errors raise :class:`~.base.MXNetError` with NVRTC's
log; CPU tensors, dtypes that disagree with the signature, and inputs
that require grad under grad mode raise too (a user kernel has no
backward). Without a card, :class:`CudaModule` raises: nothing falls
back.

:class:`TorchModule` is the counterpart of ``XLAModule`` (``rtc.py:132``):
source of plain torch functions, differentiable through autograd.

Module source is trusted code supplied by the caller, compiled (or, for
:class:`TorchModule`, executed) in this process, as in the reference.
"""
from __future__ import annotations

import ctypes
import glob
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .base import MXNetError, dtype_from_any
from .ops.kernels import _build

__all__ = ["CudaModule", "CudaKernel", "TorchModule", "TorchKernel",
           "parse_signature", "nvrtc_version"]

# C type -> (tensor dtype of a pointer to it, ctypes type of a scalar)
_C_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, None),
    "half": (torch.float16, None),
    "__nv_bfloat16": (torch.bfloat16, None),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "unsigned": (torch.int32, ctypes.c_uint32),
    "unsigned int": (torch.int32, ctypes.c_uint32),
    "uint32_t": (torch.int32, ctypes.c_uint32),
    "long long": (torch.int64, ctypes.c_int64),
    "int64_t": (torch.int64, ctypes.c_int64),
    "size_t": (torch.int64, ctypes.c_uint64),
    "char": (torch.int8, ctypes.c_int8),
    "int8_t": (torch.int8, ctypes.c_int8),
    "unsigned char": (torch.uint8, ctypes.c_uint8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "bool": (torch.bool, ctypes.c_bool),
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict",
               "__restrict"}


def parse_signature(signature: str) -> List[Tuple[str, bool, bool]]:
    """``"const float *x, int n"`` -> ``[("float", True, True),
    ("int", False, False)]``: (C type, is a pointer, is const) per
    argument. Raises :class:`MXNetError` on a type it cannot marshal."""
    out = []
    for part in signature.split(","):
        part = part.strip()
        if not part:
            raise MXNetError(f"rtc: empty argument in signature "
                             f"{signature!r}")
        ptr = part.count("*")
        if ptr > 1:
            raise MXNetError(f"rtc: {part!r}: only one level of pointer")
        words = part.replace("*", " ").split()
        const = "const" in words
        words = [w for w in words if w not in _QUALIFIERS]
        # the last word is the argument's name when more than a type remains
        for n in (len(words), len(words) - 1):
            ctype = " ".join(words[:n])
            if ctype in _C_TYPES:
                break
        else:
            raise MXNetError(f"rtc: cannot marshal argument {part!r}; C "
                             f"types: {sorted(_C_TYPES)}")
        if not ptr and _C_TYPES[ctype][1] is None:
            raise MXNetError(f"rtc: {part!r}: a {ctype} scalar cannot be "
                             "passed; pass a pointer")
        out.append((ctype, bool(ptr), const))
    return out


# ---------------------------------------------------------------------------
# NVRTC and the driver API through ctypes
# ---------------------------------------------------------------------------
_libs: Dict[str, ctypes.CDLL] = {}


def _nvrtc_candidates() -> List[str]:
    out = []
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            lib = os.path.join(home, "lib64")
            out += sorted(glob.glob(os.path.join(lib, "libnvrtc.so*")))
    # torch's bundled copy: the nvidia-cuda-nvrtc wheel beside torch, or
    # a hashed copy in torch/lib
    site = os.path.dirname(os.path.dirname(torch.__file__))
    for lib in (os.path.join(site, "nvidia", "cuda_nvrtc", "lib"),
                os.path.join(os.path.dirname(torch.__file__), "lib")):
        out += sorted(p for p in glob.glob(os.path.join(lib, "libnvrtc*.so*"))
                      if "builtins" not in os.path.basename(p))
    return out


def _nvrtc() -> ctypes.CDLL:
    lib = _libs.get("nvrtc")
    if lib is not None:
        return lib
    errors = []
    for path in _nvrtc_candidates():
        try:
            lib = ctypes.CDLL(path)
            break
        except OSError as e:
            errors.append(f"{path}: {e}")
    else:
        raise MXNetError("rtc: libnvrtc.so not found in $CUDA_HOME/lib64, "
                         "/usr/local/cuda/lib64 or beside torch"
                         + (f" ({'; '.join(errors)})" if errors else ""))
    P, PP, S = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t
    sigs = {
        "nvrtcVersion": [ctypes.POINTER(ctypes.c_int)] * 2,
        "nvrtcCreateProgram": [PP, ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int, P, P],
        "nvrtcAddNameExpression": [P, ctypes.c_char_p],
        "nvrtcCompileProgram": [P, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_char_p)],
        "nvrtcGetProgramLogSize": [P, ctypes.POINTER(S)],
        "nvrtcGetProgramLog": [P, ctypes.c_char_p],
        "nvrtcGetLoweredName": [P, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_char_p)],
        "nvrtcGetCUBINSize": [P, ctypes.POINTER(S)],
        "nvrtcGetCUBIN": [P, ctypes.c_char_p],
        "nvrtcDestroyProgram": [PP],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    _libs["nvrtc"] = lib
    return lib


def _cuda() -> ctypes.CDLL:
    lib = _libs.get("cuda")
    if lib is not None:
        return lib
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise MXNetError(f"rtc: the CUDA driver (libcuda.so.1) cannot be "
                         f"loaded: {e}") from None
    P, PP, I, U = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int, ctypes.c_uint)
    sigs = {
        "cuInit": [U],
        "cuDeviceGet": [ctypes.POINTER(I), I],
        "cuDevicePrimaryCtxRetain": [PP, I],
        "cuCtxGetCurrent": [PP],
        "cuCtxSetCurrent": [P],
        "cuModuleLoadData": [PP, P],
        "cuModuleGetFunction": [PP, P, ctypes.c_char_p],
        "cuFuncSetAttribute": [P, I, I],
        "cuLaunchKernel": [P, U, U, U, U, U, U, U, P, PP, PP],
        "cuGetErrorString": [I, ctypes.POINTER(ctypes.c_char_p)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _libs["cuda"] = lib
    return lib


def _nvrtc_check(res: int, what: str, log: str = "") -> None:
    if res != 0:
        err = _nvrtc().nvrtcGetErrorString(res).decode()
        raise MXNetError(f"rtc: {what} failed ({err})"
                         + (f":\n{log}" if log else ""))


def _cu_check(res: int, what: str) -> None:
    if res != 0:
        msg = ctypes.c_char_p()
        _cuda().cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError(f"rtc: {what} failed (CUresult {res}: "
                         f"{(msg.value or b'?').decode()})")


def nvrtc_version() -> Tuple[int, int]:
    """NVRTC's (major, minor) version."""
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(_nvrtc().nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def _arch(device: torch.device) -> str:
    major, minor = torch.cuda.get_device_capability(device)
    # 9.0 compiles for sm_90a, whose wgmma/setmaxnreg plain sm_90 refuses
    return f"sm_{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")


def _compile(source: str, options: Sequence[str], names: Sequence[str],
             arch: str) -> Tuple[bytes, Dict[str, str], str]:
    """NVRTC: source -> (cubin, name -> lowered name, log)."""
    nvrtc = _nvrtc()
    prog = ctypes.c_void_p()
    _nvrtc_check(nvrtc.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"mx_rtc.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for n in names:
            _nvrtc_check(nvrtc.nvrtcAddNameExpression(prog, n.encode()),
                         f"nvrtcAddNameExpression({n!r})")
        opts = [f"--gpu-architecture={arch}", *options]
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        if os.path.isdir(os.path.join(home, "include")):
            opts.append(f"-I{os.path.join(home, 'include')}")
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = nvrtc.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        nvrtc.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        _nvrtc_check(res, "compiling the module source", log)
        lowered = {}
        for n in names:
            low = ctypes.c_char_p()
            _nvrtc_check(nvrtc.nvrtcGetLoweredName(prog, n.encode(),
                                                   ctypes.byref(low)),
                         f"nvrtcGetLoweredName({n!r})")
            lowered[n] = low.value.decode()
        _nvrtc_check(nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(nvrtc.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw, lowered, log
    finally:
        nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))


_primary: Dict[int, ctypes.c_void_p] = {}


def _make_current(device: torch.device) -> None:
    """Make torch's primary context of ``device`` current on this
    thread (the runtime API, which torch uses, shares it)."""
    cuda = _cuda()
    ctx = _primary.get(device.index)
    if ctx is None:
        torch.cuda.init()
        _cu_check(cuda.cuInit(0), "cuInit")
        dev = ctypes.c_int()
        _cu_check(cuda.cuDeviceGet(ctypes.byref(dev), device.index),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _cu_check(cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _primary[device.index] = ctx
    cur = ctypes.c_void_p()
    _cu_check(cuda.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _cu_check(cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


class CudaModule:
    """CUDA C source compiled at run time with NVRTC (the reference's
    ``mx.rtc.CudaModule``).

    ``options`` are NVRTC options (``"--std=c++17"``, ``"-D..."``);
    ``exports`` names the kernels :meth:`get_kernel` may return, and
    each is registered as a name expression, so a kernel that is not
    ``extern "C"`` (a C++ or template kernel) is found by its C++ name.
    The source is compiled for ``device``'s architecture (``gpu(0)`` by
    default) when the module is made; it is loaded on a device at its
    first launch there. Raises :class:`MXNetError` with NVRTC's log on a
    compile error, and on a machine without a card."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = (), device=None):
        if not torch.cuda.is_available():
            raise MXNetError("rtc.CudaModule: CUDA is not available; NVRTC "
                             "kernels run only on the card")
        from .context import resolve_device

        dev = resolve_device(device)
        self._exports = list(exports)
        self._cubin, self._lowered, self.log = _compile(
            source, list(options), self._exports, _arch(dev))
        self._arch = _arch(dev)
        self._modules: Dict[int, ctypes.c_void_p] = {}

    def _module(self, device: torch.device) -> ctypes.c_void_p:
        mod = self._modules.get(device.index)
        if mod is None:
            if _arch(device) != self._arch:
                raise MXNetError(f"rtc: module compiled for {self._arch}, "
                                 f"device {device} is {_arch(device)}")
            _make_current(device)
            mod = ctypes.c_void_p()
            _cu_check(_cuda().cuModuleLoadData(ctypes.byref(mod),
                                               self._cubin),
                      "cuModuleLoadData")
            self._modules[device.index] = mod
        return mod

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` with the C ``signature`` of its
        arguments."""
        if self._exports and name not in self._exports:
            raise MXNetError(f"rtc: kernel {name!r} not in exports list "
                             f"{self._exports}")
        kernel = CudaKernel(self, name, self._lowered.get(name, name),
                            parse_signature(signature))
        kernel._function(torch.device("cuda", torch.cuda.current_device()))
        return kernel


class CudaKernel:
    """A kernel of a :class:`CudaModule` (the reference's
    ``CudaKernel``). ``CudaKernel.launches`` counts launches of every
    runtime-compiled kernel."""

    def __init__(self, module: CudaModule, name: str, lowered: str,
                 params: List[Tuple[str, bool, bool]]):
        self._module = module
        self.name = name
        self._lowered = lowered
        self._params = params
        self._functions: Dict[int, ctypes.c_void_p] = {}
        self._max_shared: Dict[int, int] = {}

    def _function(self, device: torch.device) -> ctypes.c_void_p:
        fn = self._functions.get(device.index)
        if fn is None:
            mod = self._module._module(device)
            fn = ctypes.c_void_p()
            res = _cuda().cuModuleGetFunction(ctypes.byref(fn), mod,
                                              self._lowered.encode())
            if res != 0:
                raise MXNetError(f"rtc: the module has no kernel "
                                 f"{self.name!r} (CUresult {res}); declare "
                                 "it extern \"C\" or list it in exports")
            self._functions[device.index] = fn
        return fn

    def launch(self, args: Sequence, out_shapes: Optional[Sequence] = None,
               out_dtypes: Optional[Sequence] = None, grid=(1, 1, 1),
               block=(1, 1, 1), shared_mem: int = 0):
        """Launch on ``grid`` x ``block`` with ``shared_mem`` bytes of
        dynamic shared memory. ``args`` are tensors (pointer arguments)
        and numbers (scalar arguments) in signature order; outputs of
        ``out_shapes`` (dtypes from ``out_dtypes``, else the signature)
        are allocated on the inputs' device and appended. Returns the
        output, a tuple of them, or None without ``out_shapes``."""
        what = f"rtc kernel {self.name}"
        args = list(args)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors:
            raise MXNetError(f"{what}: no tensor argument to take the "
                             "device from")
        if _build.on_cpu(what, *tensors):
            raise MXNetError(f"{what}: CPU tensors; runtime-compiled "
                             "kernels run only on the card")
        _build.refuse_grad(what, *tensors)
        dev = tensors[0].device
        outs = []
        for i, shape in enumerate(out_shapes or ()):
            k = len(args) + i
            dt = (dtype_from_any(out_dtypes[i]) if out_dtypes
                  else _C_TYPES[self._params[k][0]][0]
                  if k < len(self._params) else torch.float32)
            outs.append(torch.empty(tuple(shape), dtype=dt, device=dev))
        full = args + outs
        if len(full) != len(self._params):
            raise MXNetError(f"{what}: {len(full)} arguments (outputs "
                             f"included) for a signature of "
                             f"{len(self._params)}")
        holders = []
        for i, ((ctype, is_ptr, _), a) in enumerate(zip(self._params, full)):
            want, scalar = _C_TYPES[ctype]
            if is_ptr:
                if not isinstance(a, torch.Tensor):
                    raise MXNetError(f"{what}: argument {i} is a {ctype} "
                                     f"pointer, got {type(a).__name__}")
                if a.dtype != want:
                    raise MXNetError(f"{what}: argument {i} is a {ctype} "
                                     f"pointer, got a {a.dtype} tensor")
                if not a.is_contiguous():
                    raise MXNetError(f"{what}: argument {i} is not "
                                     "contiguous")
                holders.append(ctypes.c_void_p(a.data_ptr()))
            else:
                if isinstance(a, torch.Tensor):
                    raise MXNetError(f"{what}: argument {i} is a {ctype} "
                                     "scalar, got a tensor")
                holders.append(scalar(a))
        grid = tuple(grid) + (1,) * (3 - len(tuple(grid)))
        block = tuple(block) + (1,) * (3 - len(tuple(block)))
        with torch.cuda.device(dev):
            fn = self._function(dev)
            _make_current(dev)
            if shared_mem > 48 * 1024 and \
                    self._max_shared.get(dev.index, 0) < shared_mem:
                # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
                _cu_check(_cuda().cuFuncSetAttribute(fn, 8, shared_mem),
                          "cuFuncSetAttribute")
                self._max_shared[dev.index] = shared_mem
            params = (ctypes.c_void_p * len(holders))(
                *[ctypes.addressof(h) for h in holders])
            stream = ctypes.c_void_p(_build.stream_ptr(dev))
            _cu_check(_cuda().cuLaunchKernel(
                fn, *(int(g) for g in grid), *(int(b) for b in block),
                int(shared_mem), stream, params, None), f"launching {what}")
        CudaKernel.launches += 1
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else tuple(outs)


_build.counted(CudaKernel)


# ---------------------------------------------------------------------------
# plain torch source (the counterpart of XLAModule)
# ---------------------------------------------------------------------------
class TorchKernel:
    """A function of a :class:`TorchModule`."""

    def __init__(self, name: str, fn):
        self.name = name
        self._fn = fn

    def launch(self, args: Sequence, out_shapes: Optional[Sequence] = None,
               out_dtypes: Optional[Sequence] = None, **unused):
        """Call the function on ``args``; it returns its outputs (the
        shapes and dtypes are the function's own)."""
        return self._fn(*args)


class TorchModule:
    """Source of plain torch functions, run on any device and
    differentiable through autograd: the port's counterpart of the JAX
    package's ``mx.rtc.XLAModule`` (source of plain jnp functions).
    The source sees ``torch``, ``F`` (``torch.nn.functional``), ``math``
    and ``np`` (numpy)."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        ns = {"torch": torch, "F": torch.nn.functional, "math": math,
              "np": onp}
        try:
            exec(compile(source, "<mx.rtc.TorchModule>", "exec"), ns)
        except Exception as e:  # noqa: BLE001 — report any source error
            raise MXNetError(f"rtc: compiling TorchModule source failed: "
                             f"{e!r}") from e
        self._ns = ns
        self._exports = list(exports) or [
            k for k, v in ns.items()
            if callable(v) and getattr(v, "__module__", None) is None]

    def get_kernel(self, name: str, signature: Optional[str] = None
                   ) -> TorchKernel:
        """``signature`` is accepted for the reference's API and not
        read."""
        fn = self._ns.get(name)
        if fn is None or not callable(fn):
            raise MXNetError(f"rtc: module exports no kernel {name!r}")
        if name not in self._exports:
            raise MXNetError(f"rtc: kernel {name!r} not in exports list")
        return TorchKernel(name, fn)

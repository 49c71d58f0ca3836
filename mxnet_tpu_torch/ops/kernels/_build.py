"""Build and load the port's hand-written CUDA kernels.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` is compiled on first use by
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, where
``torch.utils.cpp_extension.load`` takes minutes). Libraries land in
``mxnet_tpu_torch/_build/``, named by a hash of the sources and flags,
so an edited source rebuilds and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source together and waits for
all of them.

A failed build raises :class:`~mxnet_tpu_torch.base.FatalError` with
the compiler's output; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

from ...base import FatalError

__all__ = ["KERNEL_SOURCES", "DTYPE_CODES", "dtype_code", "load",
           "build_all", "check", "stream_ptr", "build_log", "on_cpu",
           "require", "refuse_grad"]

_PKG = Path(__file__).resolve().parents[2]
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"
KERNEL_SOURCES = ("layer_norm", "paged_attention", "fused_decode",
                  "flash_attention", "flash_attention_bwd", "cross_entropy")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# argtypes of every C entry point: pointers and the stream as c_void_p
# (ctypes would otherwise pass a Python int as a 32-bit int and cut it)
_SIGNATURES = {
    "layer_norm": {
        "mxt_layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _I64, _I, _F, _I, _P],
        "mxt_layer_norm_fwd_warp": [_P, _P, _P, _P, _P, _P, _I64, _I, _F, _I,
                                    _P],
        "mxt_rms_norm_fwd": [_P, _P, _P, _P, _I64, _I, _F, _I, _P],
    },
    "paged_attention": {
        "mxt_paged_attention": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
        "mxt_paged_attention_span": [_P],
    },
    "fused_decode": {
        "mxt_qkv_project": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "mxt_out_project": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "mxt_qkv_cluster": [_I, _I, _I],
        "mxt_out_geometry": [_I, _I, _I, ctypes.POINTER(_I)],
    },
    "flash_attention": {
        "mxt_flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    },
    "flash_attention_bwd": {
        "mxt_flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
        "mxt_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    },
    "cross_entropy": {
        "mxt_row_lse": [_P, _P, _I64, _I64, _I, _I, _P],
    },
}


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise FatalError(f"no CUDA kernel takes dtype {dtype}") from None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise FatalError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of mxnet_tpu_torch cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in sorted(_SRC.glob("*.cuh")) + [_SRC / f"{name}.cu"]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _OUT / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (popen, tmp, final) or None
    when the library is already built."""
    final = _lib_path(name)
    if final.exists():
        return None
    _OUT.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish(name: str, started) -> None:
    proc, tmp, final = started
    out, _ = proc.communicate()
    _logs[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise FatalError(f"nvcc failed on csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{out}")
    # the log first, then the library: a library on disk has its log
    log_tmp = tmp.with_suffix(".log.tmp")
    log_tmp.write_text(out)
    os.replace(log_tmp, final.with_suffix(".log"))
    os.replace(tmp, final)      # publish by rename: readers never see half


def _open(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> List[str]:
    """Build (one nvcc per source, all started together) and load every
    named kernel library. Returns the names that were compiled now."""
    with _lock:
        names = [n for n in names if n not in _libs]
        started = {n: _start(n) for n in names}
        try:
            for n, st in started.items():
                if st is not None:
                    _finish(n, st)
        finally:
            for st in started.values():     # stop every nvcc we started
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
        for n in names:
            _libs[n] = _open(n)
        return [n for n, st in started.items() if st is not None]


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use per kernel from
    ``-Xptxas -v``) for the named library: from this process's build,
    else from the log kept beside a cached library ("" when there is
    none)."""
    if name in _logs:
        return _logs[name]
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if err != 0:
        raise FatalError(f"CUDA kernel {what} failed to launch: "
                         f"cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """The wrappers' dispatch rule: True when every tensor lies on the
    CPU (take the plain version), False when every tensor lies on one
    CUDA device (launch the kernel); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise FatalError(f"{what}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise FatalError(f"{what}: no kernel for device {dev}")
    return False


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's output carries no autograd graph on the card,
    while the plain version's would on the CPU. So a raw wrapper raises,
    on both devices, when grad mode is on and an input requires grad:
    the differentiable entry points are the ``torch.autograd.Function``s
    (``fused_layer_norm``, ``fused_rms_norm``, ``flash_attention``,
    ``cross_entropy_with_logits``); serving runs under ``no_grad``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise FatalError(
            f"{what}: an input requires grad and grad mode is on, but the "
            "kernel's output would carry no gradient; call it under "
            "torch.no_grad() or through its autograd entry point")


def require(cond: bool, what: str, msg: str) -> None:
    """Shape/dtype/layout check of a wrapper: raise on what the kernel
    does not take (never fall back)."""
    if not cond:
        raise FatalError(f"{what}: {msg}")

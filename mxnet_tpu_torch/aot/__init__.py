"""Warmup manifests of the PyTorch port (counterpart of
``mxnet_tpu/aot``). A CUDA graph cannot be stored across processes, so
the reference's persistent compile cache has no counterpart yet
(ROADMAP section 1 item 9); the manifest, which says what to capture,
is carried."""
from .manifest import WarmupManifest

__all__ = ["WarmupManifest"]

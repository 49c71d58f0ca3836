"""The ONE byte-exact KV block-row codec of the PyTorch port (the
port's own copy of ``mxnet_tpu/serving/kv_codec.py``).

The spill tiers (:mod:`~mxnet_tpu_torch.serving.kv_spill`) ship raw
paged-pool rows off the card and must round-trip the *exact* pool bytes
— including the int8 bitcast-scale layout, where each row's trailing
``_KV_SCALE_BYTES`` along the head dim are a float32 scale bitcast into
the int8 array — because byte identity is the token-identity
guarantee: a re-attached block must decode exactly as if it had never
left the card.

A payload is a dict of pool-row numpy arrays keyed ``k``/``v``
(+ ``dk``/``dv`` when speculative decoding arms draft pools), each
``(L, H, block_size, D')``; the blob is an ``npz`` archive of those
arrays, dtype- and shape-preserving. The format is the reference's, so
a blob written by either package decodes in the other.

``decode_blocks`` NEVER raises: a torn disk blob decodes as ``None`` —
a miss — so the fallback path (re-prefill) stays reachable and no
corrupt payload can ever reach the pool.
"""
from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as onp

__all__ = ["encode_blocks", "decode_blocks", "payload_nbytes"]


def encode_blocks(arrays: Dict[str, onp.ndarray]) -> bytes:
    """Serialize one block's payload dict to the wire/disk blob."""
    buf = io.BytesIO()
    onp.savez(buf, **arrays)
    return buf.getvalue()


def decode_blocks(blob: bytes) -> Optional[Dict[str, onp.ndarray]]:
    """Inverse of :func:`encode_blocks`; ``None`` on any corruption
    (the caller treats it as a miss and re-prefills)."""
    try:
        with onp.load(io.BytesIO(blob)) as z:
            return {k: z[k] for k in z.files}
    except Exception:  # noqa: BLE001 — a torn/corrupt blob reads as a miss
        return None


def payload_nbytes(arrays: Dict[str, onp.ndarray]) -> int:
    """In-memory footprint of one payload (the spill-tier accounting
    unit — NOT the blob length, which npz framing pads slightly)."""
    return sum(int(a.nbytes) for a in arrays.values())

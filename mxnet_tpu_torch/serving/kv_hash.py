"""Chain hashes of KV blocks (counterpart of
``mxnet_tpu/serving/kv_hash.py``; the same bytes).

The prefix cache of :class:`~mxnet_tpu_torch.serving.llm.LLMEngine`
keys block residency on these digests. Hash ``j`` is
``blake2b(chain_{j-1} || tokens[j*bs : (j+1)*bs].tobytes(),
digest_size=16)`` over int32 token bytes, so hash ``j`` commits to the
whole prefix ``[0, (j+1)*bs)``: equal hash means equal prefix, and a
longest-prefix match is a run of consecutive dict hits. Only full blocks
are hashed; a trailing partial block has no identity (its KV is never
shared).
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as onp

__all__ = ["chain_hashes", "prefix_key", "hash_hex"]

DIGEST_SIZE = 16


def chain_hashes(prompt, block_size: int,
                 limit: Optional[int] = None) -> List[bytes]:
    """Chain hashes of the prompt's full ``block_size``-token blocks.

    ``prompt`` is any 1-D int sequence, taken as int32 (the engine's
    prompt dtype), so equal tokens give equal bytes whatever the
    caller's dtype. ``limit`` caps the number of leading blocks
    hashed."""
    prompt = onp.asarray(prompt, onp.int32).reshape(-1)
    bs = int(block_size)
    if bs < 1:
        raise ValueError("block_size must be >= 1")
    n = int(prompt.shape[0]) // bs
    if limit is not None:
        n = min(n, max(int(limit), 0))
    out: List[bytes] = []
    chain = b""
    for j in range(n):
        chain = hashlib.blake2b(
            chain + prompt[j * bs:(j + 1) * bs].tobytes(),
            digest_size=DIGEST_SIZE).digest()
        out.append(chain)
    return out


def prefix_key(prompt, block_size: int, depth: int = 4) -> Optional[bytes]:
    """The chain hash of the prompt's leading ``min(depth, full_blocks)``
    blocks: prompts that share their first ``depth`` blocks share the
    key. None when the prompt has no full block."""
    hs = chain_hashes(prompt, block_size, limit=depth)
    return hs[-1] if hs else None


def hash_hex(h: bytes) -> str:
    """The hex form of a chain hash."""
    return h.hex()

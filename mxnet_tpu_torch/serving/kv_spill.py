"""Tiered KV block storage of the PyTorch port: the spill tiers under
the card's pool (the port's own copy of ``KVSpillTier`` in
``mxnet_tpu/serving/kv_spill.py``).

With a :class:`KVSpillTier` armed, the engine's prefix cache *demotes*
an evicted block's content instead of dropping it, down a hierarchy
indexed by the same :mod:`~mxnet_tpu_torch.serving.kv_hash` chain
hashes the prefix cache keys on:

- **host RAM**: an LRU dict of exact block payloads (the raw pool rows,
  including the int8 bitcast-scale layout — byte identity is the
  token-identity guarantee), bounded by
  ``MXNET_TPU_LLM_KV_SPILL_BYTES`` (256 MiB);
- **content-addressed disk** (optional,
  ``MXNET_TPU_LLM_KV_SPILL_DIR``): host-tier overflow demotes to
  :func:`mxnet_tpu_torch.io.cache.blob_put` blobs, one file per chain
  hash, shareable across engines on one machine and with the reference
  (same names, same :mod:`.kv_codec` bytes).

A later admission whose prefix misses the pool probes :meth:`get`
tier by tier; a hit re-attaches by a host-to-device copy (the engine
writes the rows back into freshly allocated pool blocks), and prefill
compute is skipped.

The reference's remote tier (a peer engine's spill tier fetched over
the block transport, ``serve=`` / ``peers=``) waits with the fleet for
ROADMAP section 1 item 7: asking for it raises.

The internal lock guards ONLY the host-tier dict: disk IO and
serialization run outside it, so a slow disk never wedges a concurrent
``put``.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as onp

from ..base import MXNetError, env_float
from ..io import cache as _iocache
from .kv_codec import decode_blocks, encode_blocks, payload_nbytes
from .kv_hash import hash_hex

__all__ = ["KVSpillTier", "spill_bytes_default", "spill_dir_from_env",
           "spill_peers_from_env"]


def spill_bytes_default() -> int:
    """``MXNET_TPU_LLM_KV_SPILL_BYTES`` (default 256 MiB of host RAM)."""
    return int(env_float("MXNET_TPU_LLM_KV_SPILL_BYTES",
                         256 * 1024 * 1024))


def spill_dir_from_env() -> Optional[str]:
    """``MXNET_TPU_LLM_KV_SPILL_DIR`` — arms the content-addressed disk
    tier (empty/unset = host RAM only)."""
    return os.environ.get("MXNET_TPU_LLM_KV_SPILL_DIR") or None


def spill_peers_from_env() -> List[str]:
    """``MXNET_TPU_LLM_KV_SPILL_PEERS`` — comma-separated
    ``host:port`` endpoints of peer engines' spill BlockServers."""
    raw = os.environ.get("MXNET_TPU_LLM_KV_SPILL_PEERS", "")
    return [p.strip() for p in raw.split(",") if p.strip()]


_REMOTE_WAITS = (
    "kv_spill_serve / kv_spill_peers (the remote spill tier over the block "
    "transport) are not ported: they wait for ROADMAP section 1 item 7 "
    "(the fleet and the disaggregation router)")

# the (de)serialization lives in kv_codec — ONE wire format shared with
# the reference's, so either package's blobs decode in the other
_pack = encode_blocks
_unpack = decode_blocks
_nbytes = payload_nbytes


class KVSpillTier:
    """The host-RAM / disk KV hierarchy under one engine's pool (see
    module docstring). Payloads are dicts of exact pool-row arrays keyed
    ``k``/``v`` (+ ``dk``/``dv`` when speculative decoding arms draft
    pools), indexed by the prefix cache's chain hash. ``serve=True`` and
    ``peers`` (the reference's remote tier) raise: they wait for ROADMAP
    section 1 item 7. The tier is content-addressed, so it survives an
    engine pool rebuild (a fault reset clears pool *block ids*, not the
    spilled *content*)."""

    def __init__(self, *, bytes_limit: Optional[int] = None,
                 root: Optional[str] = None,
                 peers: Optional[List[str]] = None,
                 serve: bool = False):
        self.bytes_limit = int(bytes_limit if bytes_limit is not None
                               else spill_bytes_default())
        self.root = os.path.abspath(root) if root else None
        self._lock = threading.Lock()
        self._host_tier: "OrderedDict[bytes, Dict[str, onp.ndarray]]" = \
            OrderedDict()
        self._host_bytes = 0
        self._puts = 0
        self._demoted = 0
        self._dropped = 0
        self._remote_errors = 0
        self._sweep_every = 64
        if serve or peers:
            raise MXNetError(_REMOTE_WAITS)

    # -- identity ----------------------------------------------------------
    @property
    def endpoint(self) -> Optional[str]:
        """``host:port`` of the serving side: always None here (serving a
        tier to peers waits for ROADMAP section 1 item 7)."""
        return None

    def set_peers(self, peers: List[str]) -> None:
        """Wire the remote tier's peers: an empty list is accepted (no
        remote tier), any peer raises (ROADMAP section 1 item 7)."""
        if peers:
            raise MXNetError(_REMOTE_WAITS)

    # -- the tiers ---------------------------------------------------------
    def put(self, hsh: bytes, arrays: Dict[str, onp.ndarray]) -> None:
        """Insert one evicted block's payload into the host tier
        (LRU-bump when already resident). Overflow beyond
        ``bytes_limit`` demotes oldest-first to the disk tier when one
        is armed, else drops."""
        nb = _nbytes(arrays)
        demote: List[Tuple[bytes, Dict[str, onp.ndarray]]] = []
        with self._lock:
            if hsh in self._host_tier:
                self._host_tier.move_to_end(hsh)
                return
            self._host_tier[hsh] = arrays
            self._host_bytes += nb
            self._puts += 1
            while self._host_bytes > self.bytes_limit and self._host_tier:
                h0, a0 = self._host_tier.popitem(last=False)
                self._host_bytes -= _nbytes(a0)
                demote.append((h0, a0))
        # disk IO outside the lock: a slow disk must never block a
        # concurrent put/get on the host tier
        for h0, a0 in demote:
            if self.root is not None:
                _iocache.blob_put(self.root, hash_hex(h0), _pack(a0))
                self._demoted += 1
                if self._demoted % self._sweep_every == 0:
                    # keep a shared root bounded to ~4x the host tier
                    _iocache.sweep_blob_root(
                        self.root, keep_bytes=4 * self.bytes_limit)
            else:
                self._dropped += 1

    def get(self, hsh: bytes
            ) -> Tuple[Optional[Dict[str, onp.ndarray]], Optional[str]]:
        """Probe host → disk for one chain hash. Returns ``(payload,
        tier)`` on a hit (``tier`` is ``host`` or ``disk``; a disk hit is
        promoted into the host tier), ``(None, None)`` on a miss. Never
        raises: a disk fault or a torn blob is a miss."""
        with self._lock:
            a = self._host_tier.get(hsh)
            if a is not None:
                self._host_tier.move_to_end(hsh)
                return a, "host"
        if self.root is not None:
            blob = _iocache.blob_get(self.root, hash_hex(hsh))
            if blob is not None:
                a = _unpack(blob)
                if a is not None:
                    self._promote(hsh, a)
                    return a, "disk"
        return None, None

    def _promote(self, hsh: bytes, arrays: Dict[str, onp.ndarray]) -> None:
        """A disk hit becomes a host-tier resident (the next hit is a
        memcpy, not a file read)."""
        nb = _nbytes(arrays)
        with self._lock:
            if hsh in self._host_tier:
                self._host_tier.move_to_end(hsh)
                return
            self._host_tier[hsh] = arrays
            self._host_bytes += nb
            while self._host_bytes > self.bytes_limit \
                    and len(self._host_tier) > 1:
                h0, a0 = self._host_tier.popitem(last=False)
                self._host_bytes -= _nbytes(a0)
                # promotion never demotes to disk: the evictee already
                # lives at (or below) the tier the hit came from

    # -- accounting / lifecycle --------------------------------------------
    def level(self) -> Tuple[int, int]:
        """``(blocks, bytes)`` resident in the host tier (the gauges)."""
        with self._lock:
            return len(self._host_tier), self._host_bytes

    def stats(self) -> Dict:
        blocks, nbytes = self.level()
        return {
            "host_blocks": blocks,
            "host_bytes": nbytes,
            "bytes_limit": self.bytes_limit,
            "puts": self._puts,
            "demoted_to_disk": self._demoted,
            "dropped": self._dropped,
            "remote_errors": self._remote_errors,
            "disk_root": self.root,
            "endpoint": self.endpoint,
        }

    def close(self) -> None:
        with self._lock:
            self._host_tier.clear()
            self._host_bytes = 0

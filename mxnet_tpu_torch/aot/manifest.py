"""``WarmupManifest`` — the shape frontier a serving engine of the
PyTorch port actually captured (the port's own copy of
``mxnet_tpu/aot/manifest.py``).

The engine records every program signature it ran (label, bucket,
cache dtype); the manifest is a small JSON file in the reference's
format, so either package loads the other's. A fresh engine replays it
before taking traffic: ``engine.warmup(manifest=...)`` captures exactly
the prefill buckets the previous server served.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["WarmupManifest"]

_FORMAT = 1


class WarmupManifest:
    """An append-only, deduplicated list of warmup entries.

    Each entry is a plain dict with at least ``label``; serving entries
    carry ``bucket``, ``item_shape``, ``dtype`` (what
    ``engine.warmup(manifest=...)`` replays) and — when the AOT store
    was armed — ``key`` (what ``tools/aot_warmup.py`` replays straight
    against the store). Thread-safe: the serving engine records from
    its batcher thread while callers snapshot/save concurrently.
    """

    def __init__(self, entries: Optional[List[Dict]] = None):
        self._lock = threading.Lock()
        self._entries: List[Dict] = []
        self._seen: set = set()
        for e in entries or []:
            self.record(**e)

    @staticmethod
    def _ident(entry: Dict) -> Tuple:
        return (entry.get("label"), entry.get("key"),
                entry.get("bucket"),
                tuple(entry.get("item_shape") or ()),
                entry.get("dtype"))

    def record(self, **entry) -> bool:
        """Add one entry; returns False when an identical one exists."""
        if "label" not in entry:
            raise ValueError("a manifest entry needs at least label=")
        if entry.get("item_shape") is not None:
            entry["item_shape"] = [int(d) for d in entry["item_shape"]]
        ident = self._ident(entry)
        with self._lock:
            if ident in self._seen:
                return False
            self._seen.add(ident)
            self._entries.append(dict(entry))
        return True

    def entries(self) -> List[Dict]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def serving_signatures(self) -> List[Tuple[int, Tuple[int, ...], str]]:
        """The ``(bucket, item_shape, dtype)`` frontier — every entry
        that carries the three serving fields, deduplicated, smallest
        bucket first (cheap compiles validate the replay before the
        big ones run)."""
        out = []
        for e in self.entries():
            if (e.get("bucket") is not None
                    and e.get("item_shape") is not None
                    and e.get("dtype")):
                out.append((int(e["bucket"]), tuple(e["item_shape"]),
                            str(e["dtype"])))
        return sorted(set(out))

    def keys(self) -> List[str]:
        """Store keys recorded by AOT-armed processes (may be empty)."""
        return sorted({e["key"] for e in self.entries() if e.get("key")})

    # -- persistence -----------------------------------------------------
    def save(self, path: str) -> str:
        """Atomic write (tmp → ``os.replace``), same discipline as every
        other banked artifact."""
        payload = {"format": _FORMAT, "entries": self.entries()}
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "WarmupManifest":
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or "entries" not in payload:
            raise ValueError(
                f"{path} is not a warmup manifest (no 'entries')")
        return cls(payload["entries"])

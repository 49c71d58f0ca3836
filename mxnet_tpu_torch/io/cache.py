"""The content-addressed blob store of the PyTorch port (the port's
own copy of ``blob_put``, ``blob_get`` and ``sweep_blob_root`` in
``mxnet_tpu/io/cache.py``): the KV spill tier's disk layer, one
``<root>/<key>.blob`` file per chain hash, written atomically. The file
names and contents are the reference's, so a root either package wrote
is read by the other. The rest of the reference's ``io`` package waits
(ROADMAP section 1 item 9).
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

__all__ = ["blob_put", "blob_get", "sweep_blob_root"]


# ---------------------------------------------------------------------------
# content-addressed blob store (the KV-spill disk tier)
# ---------------------------------------------------------------------------

def blob_put(root: str, key: str, payload: bytes) -> str:
    """Atomic content-addressed blob write: ``<root>/<key>.blob`` via
    tmp + ``os.replace`` (a commit by rename applied to a
    single file — a crash mid-write leaves only ``.tmp`` litter that
    :func:`sweep_blob_root` removes, never a torn blob). ``key`` is the
    content's identity (the KV chain hash in hex), so a blob that
    already exists is already CORRECT — the write is skipped, and N
    engines sharing one root converge without coordination."""
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, key + ".blob")
    if os.path.exists(path):
        return path
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    finally:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass
    return path


def blob_get(root: str, key: str) -> Optional[bytes]:
    """Read one committed blob; None when absent (or unreadable — a
    concurrent sweep winning the race reads as a miss, not a fault)."""
    try:
        with open(os.path.join(os.path.abspath(root),
                               key + ".blob"), "rb") as f:
            return f.read()
    except OSError:
        return None


def sweep_blob_root(root: str, *, keep_bytes: int,
                    ttl_s: float = 3600.0) -> Dict[str, int]:
    """Bound a shared blob root: remove ``.tmp`` litter older than
    ``ttl_s`` and, oldest-first (mtime — a blob re-put refreshes its
    slot), committed blobs beyond the ``keep_bytes`` budget.
    Race-tolerant: a concurrent winner's
    deletion never errors. Returns removal counts."""
    swept = {"tmps": 0, "blobs": 0}
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return swept
    now = time.time()
    blobs = []  # (mtime, size, path)
    for name in os.listdir(root):
        p = os.path.join(root, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        if ".tmp" in name:
            if now - st.st_mtime > ttl_s:
                try:
                    os.unlink(p)
                    swept["tmps"] += 1
                except OSError:
                    pass
        elif name.endswith(".blob"):
            blobs.append((st.st_mtime, st.st_size, p))
    total = sum(b[1] for b in blobs)
    if keep_bytes > 0 and total > keep_bytes:
        blobs.sort()                    # oldest first
        for _, size, p in blobs:
            if total <= keep_bytes:
                break
            try:
                os.unlink(p)
                swept["blobs"] += 1
                total -= size
            except OSError:
                pass
    return swept

"""RecordIO of the PyTorch port (the port's own copy of
``mxnet_tpu/recordio.py``): magic-delimited records with length headers,
the ``.idx`` sidecar, and the ``IRHeader`` image-record packing that
``ImageRecordIter`` and ``ImageRecordDataset`` read.

The wire format is the reference's, byte for byte: records are
``[kMagic:u32][lrec:u32][data][pad to 4]``, where lrec's upper 3 bits
are the continuation flag (a record holding the magic word at a 4-byte
boundary is split there, and the reader puts the word back), and a
``.idx`` file maps integer keys to byte offsets. So a file either
package writes, the other reads.

:class:`ThreadedRecordReader` reads ahead on a Python thread; the
reference's native C++ prefetcher (``src/io/prefetcher.cc``) is part of
the native engine that ROADMAP item 9a-2 ports. PIL is imported when an
encoded image is packed or decoded; without it those raise
:class:`MXNetError` naming PIL, and ``.npy`` payloads need none.
"""
from __future__ import annotations

import os
import queue
import struct
import threading
from collections import namedtuple
from typing import Dict, List, Optional

import numpy as onp

from .base import MXNetError

__all__ = [
    "MXRecordIO",
    "ThreadedRecordReader",
    "MXIndexedRecordIO",
    "IndexedRecordIO",
    "IRHeader",
    "pack",
    "unpack",
    "pack_img",
    "unpack_img",
]

_MAGIC = 0xCED7230A
_LREC_BITS = 29
_LREC_MASK = (1 << _LREC_BITS) - 1


def _make_lrec(cflag: int, length: int) -> int:
    return (cflag << _LREC_BITS) | length


class MXRecordIO:
    """Sequential RecordIO reader/writer."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        if flag == "w":
            self._fp = open(uri, "wb")
        elif flag == "r":
            self._fp = open(uri, "rb")
        else:
            raise MXNetError("flag must be 'r' or 'w'")
        self.is_open = True

    def close(self):
        if self.is_open:
            self._fp.close()
            self.is_open = False

    def reset(self):
        self._fp.seek(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tell(self) -> int:
        return self._fp.tell()

    def write(self, buf: bytes):
        if self.flag != "w":
            raise MXNetError("not opened for writing")
        if len(buf) > _LREC_MASK:
            raise MXNetError("record too large")
        # dmlc continuation scheme: split at every 4-byte-aligned embedded
        # magic word, dropping those 4 bytes (readers re-insert them);
        # cflag 1 = begin, 2 = middle, 3 = end, 0 = whole record.
        magic_b = struct.pack("<I", _MAGIC)
        n = len(buf)
        lower = (n >> 2) << 2
        dptr = 0
        pos = 0
        while True:
            j = buf.find(magic_b, pos)
            if j < 0 or j >= lower:
                break
            if j % 4 == 0:
                self._fp.write(struct.pack(
                    "<II", _MAGIC, _make_lrec(1 if dptr == 0 else 2, j - dptr)))
                self._fp.write(buf[dptr:j])  # 4-aligned: no padding needed
                dptr = j + 4
                pos = j + 4
            else:
                pos = j + 1
        self._fp.write(struct.pack(
            "<II", _MAGIC, _make_lrec(3 if dptr else 0, n - dptr)))
        self._fp.write(buf[dptr:])
        pad = (4 - (n - dptr) % 4) % 4
        if pad:
            self._fp.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        if self.flag != "r":
            raise MXNetError("not opened for reading")
        out = bytearray()
        first = True
        while True:
            header = self._fp.read(8)
            if len(header) < 8:
                if first:
                    return None  # clean EOF
                raise MXNetError("corrupt record: truncated multi-part chain")
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                raise MXNetError("invalid RecordIO magic; corrupt file?")
            cflag = lrec >> _LREC_BITS
            length = lrec & _LREC_MASK
            if cflag in (2, 3):  # re-insert the magic dropped at the split
                out += struct.pack("<I", _MAGIC)
            part = self._fp.read(length)
            if len(part) != length:
                raise MXNetError("corrupt record: truncated payload")
            out += part
            pad = (4 - length % 4) % 4
            if pad:
                self._fp.read(pad)
            first = False
            if cflag in (0, 3):
                return bytes(out)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a ``.idx`` sidecar of
    ``key\toffset`` lines."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx: Dict = {}
        self.keys: List = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if self.flag == "w" and self.is_open:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        self._fp.seek(self.idx[idx])

    def read_idx(self, idx) -> bytes:
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


IndexedRecordIO = MXIndexedRecordIO

# image record header: flag (label count, 0 for a scalar), label, id, id2
IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    flag = header.flag
    label = header.label
    if isinstance(label, (list, tuple, onp.ndarray)) and not onp.isscalar(label):
        label = onp.asarray(label, dtype=onp.float32)
        flag = label.size
        payload = struct.pack("<IfQQ", flag, 0.0, header.id, header.id2)
        return payload + label.tobytes() + s
    return struct.pack(_IR_FORMAT, flag, float(label), header.id, header.id2) + s


def unpack(s: bytes):
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    payload = s[_IR_SIZE:]
    if flag > 0:
        n = flag
        label = onp.frombuffer(payload[: 4 * n], dtype=onp.float32)
        payload = payload[4 * n :]
    header = IRHeader(flag, label, id_, id2)
    return header, payload


def pack_img(header: IRHeader, img: onp.ndarray, quality: int = 95, img_fmt: str = ".jpg") -> bytes:
    """Pack an image array: JPEG or PNG through PIL, or
    ``img_fmt='.npy'``, numpy's own framing (lossless, shape and dtype
    kept), which needs no PIL."""
    import io as _io

    buf = _io.BytesIO()
    fmt = img_fmt.lower()
    if fmt == ".npy":
        onp.save(buf, img)
    else:
        im = _pil().fromarray(onp.asarray(img, onp.uint8))
        if fmt in (".jpg", ".jpeg"):
            im.save(buf, format="JPEG", quality=quality)
        elif fmt == ".png":
            im.save(buf, format="PNG")
        else:
            raise MXNetError(f"unsupported img_fmt {img_fmt!r}")
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor=-1):
    """Unpack a record into (header, image). ``iscolor`` follows the cv2
    convention: 1 forces 3-channel RGB, 0 grayscale, -1 decodes as
    stored."""
    header, payload = unpack(s)
    img = _decode_image(payload, iscolor)
    return header, img


def _decode_image(payload: bytes, iscolor: int = -1) -> onp.ndarray:
    import io as _io

    if payload[:6] == b"\x93NUMPY":
        img = onp.load(_io.BytesIO(payload))
        if iscolor == 0 and img.ndim == 3:
            img = img.mean(axis=-1).astype(img.dtype)
        elif iscolor == 1 and img.ndim == 2:
            img = onp.repeat(img[..., None], 3, axis=-1)
        return img
    Image = _pil()
    try:
        im = Image.open(_io.BytesIO(payload))
        if iscolor == 1:
            im = im.convert("RGB")
        elif iscolor == 0:
            im = im.convert("L")
        return onp.asarray(im)
    except Exception as e:
        raise MXNetError(
            "cannot decode image payload (not npy, and PIL failed)") from e


def _pil():
    """PIL's ``Image`` module, or :class:`MXNetError` naming PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError(
            "encoding or decoding JPEG/PNG needs PIL (Pillow), which is "
            "not installed; .npy payloads need none") from e
    return Image


class ThreadedRecordReader:
    """Sequential record reader that reads ahead on a thread: up to
    ``capacity`` records wait in a queue. Iterate to get ``bytes``
    records::

        for rec in ThreadedRecordReader("data.rec"):
            ...
    """

    def __init__(self, uri: str, capacity: int = 16):
        self.uri = uri
        if not os.path.exists(uri):
            raise MXNetError(f"cannot open {uri}")
        self._reader = MXRecordIO(uri, "r")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(capacity)))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def is_native(self) -> bool:
        return False

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            while not self._stop.is_set():
                rec = self._reader.read()
                if not self._put(rec):
                    return
                if rec is None:
                    return
        except Exception as e:  # noqa: BLE001 — raised at next()
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        return item

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

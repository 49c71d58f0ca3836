"""``mx.image`` of the PyTorch port (the port's own copy of
``mxnet_tpu/image/__init__.py``, without ``detection.py``, ROADMAP
item 10, and the on-device augmentation, item 9a-2): image
loading, resizing, crops, colour normalisation, the ``Augmenter``
classes, ``CreateAugmenter`` and ``ImageIter``.

Images are HWC arrays. Each function works on the host (numpy, PIL)
and returns a tensor on the current device (``with mx.cpu():``, else
``gpu(0)``), as the reference returns device arrays; the random ones
draw from the global ``numpy.random`` state. PIL is imported when a
function needs it; without it those raise :class:`MXNetError` naming
PIL, and numpy-framed payloads (``imdecode``'s buffers, records) need
none.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import to_numpy
from .. import numpy as mxnp
from ..recordio import ThreadedRecordReader, _pil, unpack

__all__ = [
    "imread", "imdecode", "imresize", "imsave", "resize_short", "fixed_crop",
    "center_crop", "random_crop", "random_size_crop", "color_normalize",
    "HorizontalFlipAug", "RandomCropAug", "CenterCropAug", "ResizeAug",
    "ColorNormalizeAug", "CastAug", "CreateAugmenter", "ImageIter",
]


_to_np = to_numpy


def _hwc_u8(arr) -> onp.ndarray:
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr.astype(onp.uint8)


def imread(filename: str, flag: int = 1, to_rgb: bool = True):
    """Load an image file as an HWC uint8 array on the current device."""
    with _pil().open(filename) as im:
        if flag == 0:
            im = im.convert("L")
        elif im.mode != "RGB":
            im = im.convert("RGB")
        arr = onp.asarray(im)
    return mxnp.array(_hwc_u8(arr), dtype="uint8")


def imdecode(buf, flag: int = 1, to_rgb: bool = True):
    """Decode an encoded image buffer to an HWC uint8 array on the
    current device; numpy-framed payloads need no PIL."""
    import io as _io

    if isinstance(buf, torch.Tensor):
        buf = _to_np(buf).tobytes()
    elif isinstance(buf, onp.ndarray):
        buf = buf.tobytes()
    if buf[:6] == b"\x93NUMPY":
        arr = onp.load(_io.BytesIO(buf))
    else:
        with _pil().open(_io.BytesIO(buf)) as im:
            if flag == 0:
                im = im.convert("L")
            elif im.mode != "RGB":
                im = im.convert("RGB")
            arr = onp.asarray(im)
    return mxnp.array(_hwc_u8(arr), dtype="uint8")


def imresize(src, w: int, h: int, interp: int = 1):
    """Resize an HWC image to (h, w) through PIL."""
    Image = _pil()
    arr = _to_np(src)
    squeeze = arr.shape[-1] == 1
    im = Image.fromarray(arr[..., 0] if squeeze else arr.astype(onp.uint8))
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.LANCZOS}.get(interp, Image.BILINEAR)
    out = onp.asarray(im.resize((w, h), resample))
    if out.ndim == 2:
        out = out[:, :, None]
    return mxnp.array(out.astype(arr.dtype))


def imsave(filename: str, img) -> None:
    arr = _to_np(img).astype(onp.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    _pil().fromarray(arr).save(filename)


def resize_short(src, size: int, interp: int = 1):
    """Resize so the shorter side == size (reference image.py:385)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0: int, y0: int, w: int, h: int, size=None, interp: int = 1):
    """Crop [y0:y0+h, x0:x0+w] then optionally resize (reference :414)."""
    arr = _to_np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    out = mxnp.array(out)
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size: Tuple[int, int], interp: int = 1):
    """Random crop of `size` (w, h) + resize (reference :437)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    cw, ch = size
    cw, ch = min(cw, w), min(ch, h)
    x0 = onp.random.randint(0, w - cw + 1)
    y0 = onp.random.randint(0, h - ch + 1)
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def center_crop(src, size: Tuple[int, int], interp: int = 1):
    """Center crop (reference :471)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    cw, ch = size
    cw, ch = min(cw, w), min(ch, h)
    x0 = (w - cw) // 2
    y0 = (h - ch) // 2
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def random_size_crop(src, size, area, ratio, interp: int = 1):
    """Random area/aspect crop (reference :497 — the inception aug)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = onp.random.uniform(*area) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        aspect = onp.exp(onp.random.uniform(*log_ratio))
        cw = int(round(onp.sqrt(target_area * aspect)))
        ch = int(round(onp.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            x0 = onp.random.randint(0, w - cw + 1)
            y0 = onp.random.randint(0, h - ch + 1)
            return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(x - mean) / std channel-wise (reference :540)."""
    arr = _to_np(src).astype(onp.float32)
    arr = arr - onp.asarray(mean, onp.float32)
    if std is not None:
        arr = arr / onp.asarray(std, onp.float32)
    return mxnp.array(arr)


# -- augmenter objects (reference image.py Augmenter classes) --------------
class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size: int, interp: int = 1):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class HorizontalFlipAug(Augmenter):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, src):
        if onp.random.random() < self.p:
            return mxnp.array(_to_np(src)[:, ::-1])
        return src


class RandomCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 1):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 1):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class CastAug(Augmenter):
    def __init__(self, typ: str = "float32"):
        self.typ = typ

    def __call__(self, src):
        return mxnp.array(_to_np(src).astype(self.typ))


def CreateAugmenter(data_shape, resize: int = 0, rand_crop: bool = False,
                    rand_mirror: bool = False, mean=None, std=None,
                    inter_method: int = 1) -> List[Augmenter]:
    """Build the classic augmenter list from ImageRecordIter-era params
    (reference image.py:1077 CreateAugmenter)."""
    augs: List[Augmenter] = []
    if resize > 0:
        augs.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])  # (w, h)
    if rand_crop:
        augs.append(RandomCropAug(crop_size, inter_method))
    else:
        augs.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        augs.append(HorizontalFlipAug(0.5))
    augs.append(CastAug())
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None:
        augs.append(ColorNormalizeAug(mean, std))
    return augs


class ImageIter:
    """Image iterator over a ``.rec`` file or a ``.lst`` list and its
    folder, with the classic augmenter parameters; batches land on the
    device scope at construction (else ``gpu(0)``)."""

    def __init__(self, batch_size: int, data_shape: Tuple[int, int, int],
                 path_imgrec: Optional[str] = None,
                 path_imglist: Optional[str] = None,
                 path_root: str = ".", aug_list: Optional[List[Augmenter]] = None,
                 shuffle: bool = False, label_width: int = 1,
                 **aug_kwargs):
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self._dev = resolve_device()
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self.auglist = (aug_list if aug_list is not None
                        else CreateAugmenter(data_shape, **aug_kwargs))
        self._records: List[Tuple[float, bytes, Optional[str]]] = []
        if path_imgrec:
            with ThreadedRecordReader(path_imgrec) as reader:
                for rec in reader:
                    header, payload = unpack(rec)
                    label = (float(header.label)
                             if onp.isscalar(header.label)
                             else onp.asarray(header.label, onp.float32))
                    self._records.append((label, payload, None))
        elif path_imglist:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    labels = [float(x) for x in parts[1:-1]]
                    label = labels[0] if len(labels) == 1 else onp.asarray(
                        labels, onp.float32)
                    self._records.append(
                        (label, b"", os.path.join(path_root, parts[-1])))
        else:
            raise MXNetError("need path_imgrec or path_imglist")
        self._order = onp.arange(len(self._records))
        self._cursor = 0
        self.reset()

    def reset(self):
        if self._shuffle:
            onp.random.shuffle(self._order)
        self._cursor = 0

    def __iter__(self):
        return self

    def _load(self, idx: int):
        label, payload, path = self._records[idx]
        img = imdecode(payload) if payload else imread(path)
        for aug in self.auglist:
            img = aug(img)
        arr = _to_np(img)
        if arr.shape[:2] != self.data_shape[1:]:
            img = imresize(img, self.data_shape[2], self.data_shape[1])
            arr = _to_np(img)
        return arr.transpose(2, 0, 1).astype(onp.float32), label  # HWC->CHW

    def __next__(self):
        from ..io import DataBatch

        if self._cursor >= len(self._records):
            raise StopIteration
        imgs, labels = [], []
        pad = 0
        while len(imgs) < self.batch_size:
            if self._cursor >= len(self._records):
                pad += 1
                imgs.append(imgs[-1])
                labels.append(labels[-1])
                continue
            arr, label = self._load(int(self._order[self._cursor]))
            self._cursor += 1
            imgs.append(arr)
            labels.append(label)
        data = mxnp.array(onp.stack(imgs), device=self._dev)
        label = mxnp.array(onp.asarray(labels, onp.float32), device=self._dev)
        return DataBatch([data], [label], pad=pad)

    next = __next__

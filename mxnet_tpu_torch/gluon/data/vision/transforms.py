"""Vision transforms of the PyTorch port (the port's own copy of
``mxnet_tpu/gluon/data/vision/transforms.py``).

Every transform is host numpy on HWC arrays (a tensor argument is
copied to the host first), so it runs in forked loader workers; the
random ones draw from the global ``numpy.random`` state, so one numpy
seed gives one result in both packages. ``ToTensor``, ``Normalize`` and
``Cast`` also have a torch form (``_hybrid``) that
:class:`HybridCompose` runs on device tensors and that ``hybridize()``
captures in a CUDA graph; a hybridized ``HybridCompose`` refuses the
random transforms, whose host draws a graph would freeze.
"""
from __future__ import annotations

from typing import Sequence

import numpy as onp
import torch

from ....base import MXNetError, dtype_from_any
from ....ndarray.ndarray import to_numpy

__all__ = [
    "Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
    "RandomResizedCrop", "RandomCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
    "RandomBrightness", "RandomContrast", "RandomSaturation", "RandomLighting",
    "RandomColorJitter", "Pad", "RandomApply", "HybridRandomApply",
    "RandomGray", "RandomHue", "Rotate", "RandomRotation", "CropResize",
    "HybridCompose",
]


_hwc = to_numpy


def _device_tensor(x):
    """``x`` itself when a tensor, else an mx.np array of it on the
    current device (what ``_hybrid`` forms take)."""
    if isinstance(x, torch.Tensor):
        return x
    from .... import numpy as np

    return np.array(_hwc(x))


class Compose:
    def __init__(self, transforms: Sequence):
        self._transforms = list(transforms)

    def __call__(self, img, label=None):
        for t in self._transforms:
            img = t(img)
        if label is None:
            return img
        return img, label


class Cast:
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def __call__(self, img):
        return _hwc(img).astype(self._dtype)

    def _hybrid(self, x):
        """The torch form, which a CUDA graph can capture."""
        return _device_tensor(x).to(dtype_from_any(self._dtype))


class ToTensor:
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference ToTensor)."""

    def __call__(self, img):
        img = _hwc(img)
        if img.ndim == 2:
            img = img[:, :, None]
        return (img.astype(onp.float32) / 255.0).transpose(2, 0, 1)

    def _hybrid(self, x):
        """The torch form (HWC or NHWC), which a CUDA graph can
        capture."""
        x = _device_tensor(x)
        if x.dim() == 2:
            x = x.unsqueeze(-1)
        x = x.to(torch.float32) / 255.0
        axes = (2, 0, 1) if x.dim() == 3 else (0, 3, 1, 2)
        return x.permute(axes)


class Normalize:
    def __init__(self, mean=0.0, std=1.0):
        self._mean = onp.asarray(mean, onp.float32).reshape(-1, 1, 1)
        self._std = onp.asarray(std, onp.float32).reshape(-1, 1, 1)
        self._consts = {}

    def __call__(self, img):
        img = _hwc(img)
        if img.ndim == 3 and img.shape[0] not in (1, 3):  # HWC -> error guard
            raise MXNetError("Normalize expects CHW input (apply ToTensor first)")
        return (img - self._mean) / self._std

    def _hybrid(self, x):
        """The torch form; mean and std are made on x's device once (in
        the warm-up run, before a graph captures the call)."""
        x = _device_tensor(x)
        consts = self._consts.get(x.device)
        if consts is None:
            consts = self._consts[x.device] = (
                torch.from_numpy(self._mean).to(x.device),
                torch.from_numpy(self._std).to(x.device))
        mean, std = consts
        return (x - mean) / std


def _resize_hwc(img, size):
    """Bilinear resize without cv2 (vectorized numpy)."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        ow, oh = size, size
    else:
        ow, oh = size
    if (h, w) == (oh, ow):
        return img
    ys = onp.linspace(0, h - 1, oh)
    xs = onp.linspace(0, w - 1, ow)
    y0 = onp.floor(ys).astype(int)
    x0 = onp.floor(xs).astype(int)
    y1 = onp.minimum(y0 + 1, h - 1)
    x1 = onp.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img_f = img.astype(onp.float32)
    if img_f.ndim == 2:
        img_f = img_f[:, :, None]
    top = img_f[y0][:, x0] * (1 - wx) + img_f[y0][:, x1] * wx
    bot = img_f[y1][:, x0] * (1 - wx) + img_f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.dtype == onp.uint8:
        out = onp.clip(onp.round(out), 0, 255).astype(onp.uint8)
    return out


class Resize:
    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = size
        self._keep = keep_ratio

    def __call__(self, img):
        img = _hwc(img)
        if self._keep:
            h, w = img.shape[:2]
            short = self._size if isinstance(self._size, int) else min(self._size)
            scale = short / min(h, w)
            return _resize_hwc(img, (int(round(w * scale)), int(round(h * scale))))
        return _resize_hwc(img, self._size)


class CenterCrop:
    def __init__(self, size):
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = _hwc(img)
        h, w = img.shape[:2]
        cw, ch = self._size
        x0 = max(0, (w - cw) // 2)
        y0 = max(0, (h - ch) // 2)
        out = img[y0 : y0 + ch, x0 : x0 + cw]
        if out.shape[:2] != (ch, cw):
            out = _resize_hwc(img, self._size)
        return out


class RandomCrop:
    _random = True  # draws from numpy.random

    def __init__(self, size, pad=None, pad_value=0):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._pad_value = pad_value

    def __call__(self, img):
        img = _hwc(img)
        if self._pad:
            p = self._pad
            img = onp.pad(img, ((p, p), (p, p), (0, 0)), constant_values=self._pad_value)
        h, w = img.shape[:2]
        cw, ch = self._size
        if h < ch or w < cw:
            img = _resize_hwc(img, (max(cw, w), max(ch, h)))
            h, w = img.shape[:2]
        y0 = onp.random.randint(0, h - ch + 1)
        x0 = onp.random.randint(0, w - cw + 1)
        return img[y0 : y0 + ch, x0 : x0 + cw]


class RandomResizedCrop:
    _random = True  # draws from numpy.random

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def __call__(self, img):
        img = _hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = onp.random.uniform(*self._scale) * area
            aspect = onp.exp(onp.random.uniform(onp.log(self._ratio[0]), onp.log(self._ratio[1])))
            cw = int(round(onp.sqrt(target_area * aspect)))
            ch = int(round(onp.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = onp.random.randint(0, w - cw + 1)
                y0 = onp.random.randint(0, h - ch + 1)
                return _resize_hwc(img[y0 : y0 + ch, x0 : x0 + cw], self._size)
        return _resize_hwc(img, self._size)


class RandomFlipLeftRight:
    _random = True  # draws from numpy.random

    def __call__(self, img):
        img = _hwc(img)
        if onp.random.rand() < 0.5:
            return img[:, ::-1]
        return img


class RandomFlipTopBottom:
    _random = True  # draws from numpy.random

    def __call__(self, img):
        img = _hwc(img)
        if onp.random.rand() < 0.5:
            return img[::-1]
        return img


class RandomBrightness:
    _random = True  # draws from numpy.random

    def __init__(self, brightness):
        self._b = brightness

    def __call__(self, img):
        img = _hwc(img).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._b, self._b)
        return img * alpha


class RandomContrast:
    _random = True  # draws from numpy.random

    def __init__(self, contrast):
        self._c = contrast

    def __call__(self, img):
        img = _hwc(img).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._c, self._c)
        gray = img.mean()
        return img * alpha + gray * (1 - alpha)


class RandomSaturation:
    _random = True  # draws from numpy.random

    def __init__(self, saturation):
        self._s = saturation

    def __call__(self, img):
        img = _hwc(img).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._s, self._s)
        gray = img.mean(axis=2, keepdims=True)
        return img * alpha + gray * (1 - alpha)


class RandomLighting:
    """AlexNet-style PCA lighting noise (reference RandomLighting)."""

    _random = True  # draws from numpy.random

    _eigval = onp.array([55.46, 4.794, 1.148], onp.float32)
    _eigvec = onp.array(
        [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.814], [-0.5836, -0.6948, 0.4203]],
        onp.float32,
    )

    def __init__(self, alpha):
        self._alpha = alpha

    def __call__(self, img):
        img = _hwc(img).astype(onp.float32)
        alpha = onp.random.normal(0, self._alpha, 3).astype(onp.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return img + rgb


class RandomColorJitter:
    _random = True  # draws from numpy.random

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def __call__(self, img):
        ts = list(self._ts)
        onp.random.shuffle(ts)
        for t in ts:
            img = t(img)
        return img


class Pad:
    def __init__(self, padding, fill=0):
        self._p = (padding,) * 4 if isinstance(padding, int) else tuple(padding)
        self._fill = fill

    def __call__(self, img):
        img = _hwc(img)
        l, t, r, b = self._p
        pads = ((t, b), (l, r)) + (((0, 0),) if img.ndim == 3 else ())
        return onp.pad(img, pads, constant_values=self._fill)


class RandomApply:
    """Apply a transform with probability p (reference transforms
    RandomApply)."""

    _random = True  # draws from numpy.random

    def __init__(self, transform, p=0.5):
        self._t = transform
        self._p = p

    def __call__(self, img):
        if onp.random.uniform() < self._p:
            return self._t(img)
        return _hwc(img)


HybridRandomApply = RandomApply  # hybrid variant is the same on host numpy


class RandomGray:
    """Convert to 3-channel grayscale with probability p (reference
    transforms RandomGray)."""

    _random = True  # draws from numpy.random

    def __init__(self, p=0.5):
        self._p = p

    def __call__(self, img):
        img = _hwc(img)
        if onp.random.uniform() < self._p:
            gray = (img.astype(onp.float32)
                    @ onp.array([0.299, 0.587, 0.114], onp.float32))
            img = onp.repeat(gray[..., None], 3, axis=-1).astype(img.dtype)
        return img


class RandomHue:
    """Jitter hue by a factor in [max(0,1-hue), 1+hue] using the
    reference's YIQ rotation approximation (image.py RandomHueAug)."""

    _random = True  # draws from numpy.random

    def __init__(self, hue):
        self._h = hue

    def __call__(self, img):
        img = _hwc(img).astype(onp.float32)
        alpha = onp.random.uniform(-self._h, self._h)
        u = onp.cos(alpha * onp.pi)
        w = onp.sin(alpha * onp.pi)
        bt = onp.array([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.321],
                        [0.211, -0.523, 0.311]], onp.float32)
        ibt = onp.array([[1.0, 0.956, 0.621],
                         [1.0, -0.272, -0.647],
                         [1.0, -1.107, 1.705]], onp.float32)
        t = onp.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], onp.float32)
        m = ibt @ t @ bt
        return img @ m.T


def _rotate(img, deg, zoom_in=False, zoom_out=False):
    """Bilinear rotation about the center, zero-filled (reference
    transforms Rotate / image.imrotate)."""
    img = _hwc(img).astype(onp.float32)
    two_d = img.ndim == 2
    if two_d:
        img = img[:, :, None]
    H, W, C = img.shape
    rad = onp.deg2rad(deg)
    c, s = onp.cos(rad), onp.sin(rad)
    scale = 1.0
    if zoom_in or zoom_out:
        # zoom so the rotated frame fits (out) or fills (in) the canvas
        fit_w = abs(c) * W + abs(s) * H
        fit_h = abs(s) * W + abs(c) * H
        if zoom_out:
            scale = max(fit_w / W, fit_h / H)
        else:
            # magnify (< 1 in the inverse map) until the largest rectangle
            # that fits inside the rotated image fills the canvas
            # (reference image.py:708-710 uses the min ratio directly)
            scale = min(W / fit_w, H / fit_h)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys, xs = onp.mgrid[0:H, 0:W].astype(onp.float32)
    # inverse mapping: output pixel -> source coordinate
    dy, dx = (ys - cy) * scale, (xs - cx) * scale
    sy = cy + (c * dy - s * dx)
    sx = cx + (s * dy + c * dx)
    y0 = onp.floor(sy).astype(onp.int64)
    x0 = onp.floor(sx).astype(onp.int64)
    wy, wx = sy - y0, sx - x0
    out = onp.zeros_like(img)
    for dy2 in (0, 1):
        for dx2 in (0, 1):
            yy, xx = y0 + dy2, x0 + dx2
            valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            yc = onp.clip(yy, 0, H - 1)
            xc = onp.clip(xx, 0, W - 1)
            wgt = ((wy if dy2 else 1 - wy) * (wx if dx2 else 1 - wx) * valid)
            out += img[yc, xc] * wgt[..., None]
    return out[:, :, 0] if two_d else out


class Rotate:
    """Rotate by a fixed angle in degrees (reference transforms Rotate)."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        self._deg = rotation_degrees
        self._zi, self._zo = zoom_in, zoom_out

    def __call__(self, img):
        return _rotate(img, self._deg, self._zi, self._zo)


class RandomRotation:
    """Rotate by a uniform random angle from [lo, hi] degrees (reference
    transforms RandomRotation)."""

    _random = True  # draws from numpy.random

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        lo, hi = angle_limits
        self._lo, self._hi = lo, hi
        self._zi, self._zo = zoom_in, zoom_out
        self._p = rotate_with_proba

    def __call__(self, img):
        if onp.random.uniform() >= self._p:
            return _hwc(img)
        deg = onp.random.uniform(self._lo, self._hi)
        return _rotate(img, deg, self._zi, self._zo)


class CropResize:
    """Crop a fixed box then resize (reference transforms CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        self._box = (x, y, width, height)
        self._size = size

    def __call__(self, img):
        img = _hwc(img)
        x, y, w, h = self._box
        img = img[y: y + h, x: x + w]
        if self._size is not None:
            img = Resize(self._size)(img)
        return img


from ...block import HybridBlock  # noqa: E402 — the host transforms above
# need no block machinery


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class HybridCompose(HybridBlock):
    """Compose transforms inside a block's forward: each runs its torch
    form (``_hybrid``) where it has one and is called as it is
    otherwise. Hybridized, on device tensors, the forward is replayed
    from a CUDA graph; the random transforms then raise
    :class:`MXNetError`, since a graph would replay the draws of its
    capture."""

    def __init__(self, transforms):
        super().__init__()
        self._transforms = list(transforms)

    def hybridize(self, active: bool = True, **kwargs):
        if active:
            bad = [type(t).__name__ for t in self._transforms
                   if getattr(t, "_random", False)]
            if bad:
                raise MXNetError(
                    f"HybridCompose.hybridize(): {bad} draw from "
                    "numpy.random on the host, which a captured graph "
                    "would freeze; apply them outside the hybridized "
                    "block")
        super().hybridize(active, **kwargs)

    def forward(self, x):
        for t in self._transforms:
            if getattr(t, "_random", False) and _capturing():
                raise MXNetError(
                    f"HybridCompose: {type(t).__name__} draws on the host, "
                    "which a captured graph would freeze")
            fn = getattr(t, "_hybrid", None)
            x = fn(x) if fn is not None else t(x)
        return x

    def __repr__(self):
        inner = ", ".join(type(t).__name__ for t in self._transforms)
        return f"HybridCompose([{inner}])"

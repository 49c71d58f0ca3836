"""Vision datasets of the PyTorch port (the port's own copy of
``mxnet_tpu/gluon/data/vision/datasets.py``).

MNIST, FashionMNIST and CIFAR read the standard on-disk formats from
``root`` (``MXNET_HOME``/``~/.mxnet/datasets`` by default); nothing is
downloaded. When the files are absent and ``synthetic_ok`` is set (or
``MXNET_SYNTHETIC_DATA``, true by default), a deterministic synthetic
stand-in of the same shape and dtype is drawn, exactly what the
reference draws, so both packages hold the same samples. Images are
host numpy HWC uint8.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Optional

import numpy as onp

from ....base import MXNetError, env_bool, env_str
from .. import dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageFolderDataset",
           "ImageRecordDataset", "ImageListDataset"]


def _data_root(root: Optional[str]) -> str:
    if root:
        return os.path.expanduser(root)
    home = env_str("MXNET_HOME", os.path.join(os.path.expanduser("~"), ".mxnet"))
    return os.path.join(home, "datasets")


def _synthetic_allowed(explicit: Optional[bool]) -> bool:
    if explicit is not None:
        return explicit
    return env_bool("MXNET_SYNTHETIC_DATA", True)


class _DownloadedDataset(dataset.Dataset):
    def __init__(self, root, train, transform):
        self._root = root
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """reference datasets.py MNIST (idx-ubyte format)."""

    _ns = "mnist"
    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root=None, train=True, transform=None, synthetic_ok=None):
        self._synth = _synthetic_allowed(synthetic_ok)
        super().__init__(os.path.join(_data_root(root), self._ns), train, transform)

    def _files(self):
        if self._train:
            return "train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz", 60000
        return "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz", 10000

    def _get_data(self):
        img_f, lbl_f, n = self._files()
        img_path = os.path.join(self._root, img_f)
        lbl_path = os.path.join(self._root, lbl_f)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                self._label = onp.frombuffer(f.read(), dtype=onp.uint8).astype(onp.int32)
            with gzip.open(img_path, "rb") as f:
                _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                data = onp.frombuffer(f.read(), dtype=onp.uint8)
                self._data = data.reshape(num, rows, cols, 1)
        elif self._synth:
            rng = onp.random.RandomState(42 if self._train else 43)
            n = min(n, 8192)
            self._label = rng.randint(0, self._classes, n).astype(onp.int32)
            base = rng.randint(0, 255, (self._classes,) + self._shape)
            noise = rng.randint(0, 64, (n,) + self._shape)
            self._data = onp.clip(base[self._label] * 0.75 + noise, 0, 255).astype(onp.uint8)
        else:
            raise MXNetError(f"MNIST files not found under {self._root} (no egress to download)")


class FashionMNIST(MNIST):
    _ns = "fashion-mnist"


def _extract_if_tar(batch_dir, tar_path, root):
    if not os.path.isdir(batch_dir) and os.path.exists(tar_path):
        with tarfile.open(tar_path) as t:
            t.extractall(root, filter="data")
    return os.path.isdir(batch_dir)


def _synthetic_cifar(seed, n, n_cls):
    rng = onp.random.RandomState(seed)
    label = rng.randint(0, n_cls, n).astype(onp.int32)
    base = rng.randint(0, 255, (n_cls, 32, 32, 3))
    noise = rng.randint(0, 80, (n, 32, 32, 3))
    data = onp.clip(base[label] * 0.7 + noise, 0, 255).astype(onp.uint8)
    return data, label


class CIFAR10(_DownloadedDataset):
    """reference datasets.py CIFAR10 (python pickled batches)."""

    _classes = 10
    _archive = "cifar-10-batches-py"

    def __init__(self, root=None, train=True, transform=None, synthetic_ok=None):
        self._synth = _synthetic_allowed(synthetic_ok)
        super().__init__(os.path.join(_data_root(root), "cifar10"), train, transform)

    def _get_data(self):
        batch_dir = os.path.join(self._root, self._archive)
        tar_path = os.path.join(self._root, "cifar-10-python.tar.gz")
        if _extract_if_tar(batch_dir, tar_path, self._root):
            files = (
                [f"data_batch_{i}" for i in range(1, 6)] if self._train else ["test_batch"]
            )
            data, labels = [], []
            for fname in files:
                with open(os.path.join(batch_dir, fname), "rb") as f:
                    batch = pickle.load(f, encoding="latin1")
                data.append(batch["data"])
                labels.extend(batch.get("labels", batch.get("fine_labels")))
            raw = onp.concatenate(data).reshape(-1, 3, 32, 32)
            self._data = raw.transpose(0, 2, 3, 1)  # HWC like the reference
            self._label = onp.asarray(labels, dtype=onp.int32)
        elif self._synth:
            self._data, self._label = _synthetic_cifar(
                7 if self._train else 8, 8192 if self._train else 2048, self._classes)
        else:
            raise MXNetError(f"CIFAR-10 not found under {self._root} (no egress to download)")


class CIFAR100(CIFAR10):
    _classes = 100
    _archive = "cifar-100-python"

    def __init__(self, root=None, fine_label=True, train=True, transform=None, synthetic_ok=None):
        self._fine = fine_label
        self._synth = _synthetic_allowed(synthetic_ok)
        _DownloadedDataset.__init__(
            self, os.path.join(_data_root(root), "cifar100"), train, transform
        )

    def _get_data(self):
        # CIFAR-100 archive layout differs from CIFAR-10: single 'train' /
        # 'test' pickles with fine_labels + coarse_labels
        batch_dir = os.path.join(self._root, self._archive)
        tar_path = os.path.join(self._root, "cifar-100-python.tar.gz")
        if _extract_if_tar(batch_dir, tar_path, self._root):
            fname = "train" if self._train else "test"
            with open(os.path.join(batch_dir, fname), "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            raw = onp.asarray(batch["data"]).reshape(-1, 3, 32, 32)
            self._data = raw.transpose(0, 2, 3, 1)
            key = "fine_labels" if self._fine else "coarse_labels"
            self._label = onp.asarray(batch[key], dtype=onp.int32)
        elif self._synth:
            self._data, self._label = _synthetic_cifar(
                9 if self._train else 10, 8192 if self._train else 2048,
                self._classes if self._fine else 20)
        else:
            raise MXNetError(f"CIFAR-100 not found under {self._root} (no egress to download)")


def _load_image(fname, flag):
    """Load an image file as ndarray; flag=1 -> RGB, 0 -> grayscale."""
    if fname.endswith(".npy"):
        return onp.load(fname)
    from ....recordio import _pil

    return onp.asarray(_pil().open(fname).convert("RGB" if flag else "L"))


class ImageFolderDataset(dataset.Dataset):
    """reference vision/datasets.py ImageFolderDataset: root/class/*.jpg"""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        img = _load_image(fname, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageRecordDataset(dataset.RecordFileDataset):
    """Dataset over an image ``.rec`` file (reference vision/datasets.py
    ImageRecordDataset:238): each record unpacks to (image, label) via the
    IRHeader wire format the C++ reader/im2rec produce."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        if transform is not None:
            raise MXNetError(
                "transform= is deprecated in the reference; use "
                "dataset.transform() / transform_first()")
        self._flag = flag

    def __getitem__(self, idx):
        from ....recordio import unpack_img

        record = super().__getitem__(idx)
        header, img = unpack_img(record, iscolor=self._flag)
        label = header.label
        if hasattr(label, "__len__") and len(label) == 1:
            label = label[0]
        return img, label


class ImageListDataset(dataset.Dataset):
    """Dataset over an im2rec-style ``.lst`` list (reference
    vision/datasets.py ImageListDataset:365): rows of
    ``index\\tlabel(s)\\trelpath`` or an in-memory ``[label, path]`` list."""

    def __init__(self, root=".", imglist=None, flag=1):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self.items = []
        if isinstance(imglist, str):
            with open(os.path.join(self._root, imglist)) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    label = ([float(v) for v in parts[1:-1]]
                             if len(parts) > 3 else float(parts[1]))
                    self.items.append((os.path.join(self._root, parts[-1]),
                                       label))
        elif imglist is not None:
            for entry in imglist:
                label, path = entry[0], entry[-1]
                self.items.append((os.path.join(self._root, path), label))
        else:
            raise MXNetError("ImageListDataset requires imglist")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        return _load_image(fname, self._flag), label

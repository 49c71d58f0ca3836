"""``gluon.data.vision`` of the PyTorch port: datasets and transforms."""
from . import transforms  # noqa: F401
from .datasets import (  # noqa: F401
    CIFAR10,
    CIFAR100,
    FashionMNIST,
    ImageFolderDataset,
    ImageListDataset,
    ImageRecordDataset,
    MNIST,
)

__all__ = ["transforms", "CIFAR10", "CIFAR100", "FashionMNIST",
           "ImageFolderDataset", "ImageListDataset", "ImageRecordDataset",
           "MNIST"]

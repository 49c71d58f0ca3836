"""``gluon.data`` of the PyTorch port (counterpart of
``mxnet_tpu/gluon/data``): datasets, samplers, batchify functions and
the DataLoader, which uploads each host batch to the device."""
from . import vision  # noqa: F401
from .batchify import (Append, AsList, Group, Pad, Stack,  # noqa: F401
                       default_batchify_fn)
from .dataloader import DataLoader  # noqa: F401
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .sampler import (  # noqa: F401
    BatchSampler,
    FilterSampler,
    IntervalSampler,
    RandomSampler,
    Sampler,
    SequentialSampler,
)

__all__ = ["vision", "Append", "AsList", "Group", "Pad", "Stack",
           "default_batchify_fn", "DataLoader", "ArrayDataset", "Dataset",
           "RecordFileDataset", "SimpleDataset", "BatchSampler",
           "FilterSampler", "IntervalSampler", "RandomSampler", "Sampler",
           "SequentialSampler"]

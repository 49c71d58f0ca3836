"""``mx.gluon.contrib`` of the PyTorch port (counterpart of
``mxnet_tpu/gluon/contrib/``): :mod:`.cnn`'s deformable convolutions.
Its ``nn``, ``rnn``, ``data`` and ``estimator`` wait for ``ROADMAP.md``
§1 item 10."""
from . import cnn  # noqa: F401

__all__ = ["cnn"]

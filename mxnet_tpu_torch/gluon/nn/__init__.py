"""Layers of the PyTorch port (Gluon blocks, which are ``nn.Module``s)."""
from ..block import Block, HybridBlock
from .basic_layers import (Activation, Dense, Dropout, Embedding, Flatten,
                           HybridConcatenate, HybridLambda, HybridSequential,
                           Identity, Lambda, Sequential)
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_all
from .norm_layers import (BatchNorm, BatchNormReLU, LayerNorm, RMSNorm,
                          SyncBatchNorm)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "HybridConcatenate", "Dense", "Dropout", "Activation",
           "Embedding", "Flatten", "Identity", "Lambda", "HybridLambda",
           "BatchNorm",
           "SyncBatchNorm", "BatchNormReLU", "LayerNorm", "RMSNorm",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderLayer"] + _conv_all

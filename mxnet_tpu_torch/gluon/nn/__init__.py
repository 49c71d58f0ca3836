"""Layers of the PyTorch port (Gluon blocks, which are ``nn.Module``s)."""
from ..block import Block, HybridBlock
from .basic_layers import (ELU, GELU, SELU, Activation, Concatenate, Dense,
                           Dropout, Embedding, Flatten, HybridConcatenate,
                           HybridLambda, HybridSequential, Identity, Lambda,
                           LeakyReLU, PReLU, Sequential, SiLU, Swish)
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_all
from .norm_layers import (BatchNorm, BatchNormReLU, GroupNorm, InstanceNorm,
                          LayerNorm, RMSNorm, SyncBatchNorm)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Concatenate", "HybridConcatenate", "Dense", "Dropout",
           "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "SiLU",
           "Swish", "GroupNorm", "InstanceNorm",
           "Embedding", "Flatten", "Identity", "Lambda", "HybridLambda",
           "BatchNorm",
           "SyncBatchNorm", "BatchNormReLU", "LayerNorm", "RMSNorm",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderLayer"] + _conv_all

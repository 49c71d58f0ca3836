"""Layers of the PyTorch port (Gluon blocks, which are ``nn.Module``s)."""
from ..block import Block, HybridBlock
from .basic_layers import (Activation, Dense, Dropout, Embedding,
                           HybridLambda, HybridSequential, Lambda,
                           Sequential)
from .norm_layers import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "Dropout", "Activation", "Embedding", "Lambda",
           "HybridLambda", "LayerNorm", "RMSNorm", "MultiHeadAttention",
           "PositionwiseFFN", "TransformerEncoder", "TransformerEncoderLayer"]

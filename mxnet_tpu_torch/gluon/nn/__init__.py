"""Layers of the PyTorch port (``nn.Module``s)."""
from .basic_layers import Dense, Dropout, Embedding
from .norm_layers import LayerNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderLayer"]

"""Model zoo of the PyTorch port."""
from . import bert, generation

__all__ = ["bert", "generation"]

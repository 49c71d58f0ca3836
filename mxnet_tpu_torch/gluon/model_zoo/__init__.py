"""Model zoo of the PyTorch port."""
from . import bert, generation, vision

__all__ = ["bert", "generation", "vision"]

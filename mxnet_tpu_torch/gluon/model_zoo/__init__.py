"""Model zoo of the PyTorch port."""
from . import bert, generation, vision
from .vision import get_model

__all__ = ["bert", "generation", "vision", "get_model"]

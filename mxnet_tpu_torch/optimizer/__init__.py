"""``optimizer`` of the PyTorch port: the registry and the optimizers the
training slice runs."""
from .optimizer import SGD, Adam, AdamW, Optimizer, create, register

__all__ = ["Optimizer", "register", "create", "SGD", "Adam", "AdamW"]

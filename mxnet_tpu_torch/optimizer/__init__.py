"""``optimizer`` of the PyTorch port: the registry, the optimizer zoo,
``Updater`` and the learning-rate schedulers."""
from .optimizer import (SGD, NAG, LAMB, LARS, FTML, Ftrl, Adam, AdamW,
                        Adamax, Nadam, AdaGrad, AdaDelta, RMSProp, Signum,
                        SGLD, DCASGD, GroupAdaGrad, Optimizer, Updater,
                        create, get_updater, register)
from . import lr_scheduler
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)

__all__ = ["Optimizer", "register", "create", "Updater", "get_updater",
           "SGD", "NAG", "Signum", "SGLD", "DCASGD", "LARS", "Adam", "AdamW",
           "Adamax", "Nadam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "FTML", "LAMB", "GroupAdaGrad", "lr_scheduler", "LRScheduler",
           "FactorScheduler", "MultiFactorScheduler", "PolyScheduler",
           "CosineScheduler"]

"""Optimizers for the LM training path (the counterpart of ``repro.optim``)."""

from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, get_optimizer, sgd

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "get_optimizer"]

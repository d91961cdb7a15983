"""Training substrate: optimizers over tensor trees."""

from .optimizer import AdamW, Optimizer, SGD  # noqa: F401

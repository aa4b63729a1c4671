"""Optimizers and learning-rate schedules (the JAX package's ``optim/``):
pure transforms on dicts of tensors, plain torch."""
from .sgd import Optimizer, adam, sgd  # noqa: F401
from .schedule import constant, cosine, step_decay  # noqa: F401

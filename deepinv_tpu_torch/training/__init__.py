"""Training of the port (deepinv_tpu/training/)."""

from .trainer import Trainer, test

__all__ = ["Trainer", "test"]

"""Training of the port (deepinv_tpu/training/)."""

from .adversarial import AdversarialOptimizer, AdversarialTrainer
from .checkpoint import OrbaxCheckpointer
from .trainer import Trainer, test

__all__ = ["Trainer", "test", "train", "OrbaxCheckpointer", "AdversarialTrainer",
           "AdversarialOptimizer"]


def train(model, physics, train_dataloader, epochs: int = 100, **kwargs):
    """Build a :class:`Trainer` and run it; returns the trained model
    (deepinv_tpu/training/__init__.py:6)."""
    t = Trainer(model, physics, train_dataloader=train_dataloader, epochs=epochs, **kwargs)
    t.train()
    return t.model

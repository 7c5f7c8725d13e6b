"""Loss schedulers (port of deepinv_tpu/loss/scheduler.py): which losses
are active at a call.

The choices are Python's ``random.Random(seed)``, as in the JAX package
(scheduler.py:27-66), so the two make the same choices call for call. The
JAX ``Trainer`` calls a scheduler like any loss, without ``epoch`` or
``step`` (trainer.py:343-360), so the epoch- and step-driven schedulers see
0; the port's ``Trainer`` does the same.
"""

from __future__ import annotations

import random as _random
from typing import List

from .base import Loss

__all__ = ["BaseLossScheduler", "RandomLossScheduler", "InterleavedLossScheduler",
           "StepLossScheduler", "InterleavedEpochLossScheduler"]


class BaseLossScheduler(Loss):
    """A list of losses, a subset active at a call (scheduler.py:24); the
    sum of the active ones, 0.0 if none is."""

    def __init__(self, *losses: Loss, seed: int = 0):
        self.losses = list(losses)
        self.rng = _random.Random(seed)

    def select(self, epoch: int = 0, step: int = 0) -> List[Loss]:
        return self.losses

    def schedule(self, epoch: int = 0) -> List[Loss]:
        """The reference's name of :meth:`select` (scheduler.py:34)."""
        return self.select(epoch=epoch)

    def __call__(self, epoch: int = 0, step: int = 0, **kwargs):
        total = 0.0
        for l in self.select(epoch=epoch, step=step):
            total = total + l(**kwargs)
        return total

    def adapt_model(self, model):
        for l in self.losses:
            model = l.adapt_model(model)
        return model


class RandomLossScheduler(BaseLossScheduler):
    """One loss a call at random, ``weightings`` its odds (scheduler.py:50)."""

    def __init__(self, *losses: Loss, seed: int = 0, weightings=None):
        super().__init__(*losses, seed=seed)
        self.weightings = weightings
        if weightings is not None and len(self.losses) != len(weightings):
            raise ValueError("losses and weightings must be same length")

    def select(self, epoch=0, step=0):
        if self.weightings is None:
            return [self.rng.choice(self.losses)]
        return [self.rng.choices(self.losses, weights=self.weightings, k=1)[0]]


class InterleavedLossScheduler(BaseLossScheduler):
    """The losses in turn, step by step (scheduler.py:68)."""

    def select(self, epoch=0, step=0):
        return [self.losses[step % len(self.losses)]]


class InterleavedEpochLossScheduler(BaseLossScheduler):
    """The losses in turn, epoch by epoch (scheduler.py:75)."""

    def select(self, epoch=0, step=0):
        return [self.losses[epoch % len(self.losses)]]


class StepLossScheduler(BaseLossScheduler):
    """Every loss, once ``epoch > epoch_thresh`` (scheduler.py:82)."""

    def __init__(self, *losses: Loss, epoch_thresh: int = 0):
        super().__init__(*losses)
        self.epoch_thresh = epoch_thresh

    def select(self, epoch=0, step=0):
        return list(self.losses) if epoch > self.epoch_thresh else []

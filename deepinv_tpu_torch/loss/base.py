"""Loss base class (port of deepinv_tpu/loss/base.py).

Signature: ``loss(x_net=..., x=..., y=..., physics=..., model=...,
generator=...)`` returning per-sample values of shape (B,); the trainer
reduces them. Stochastic losses draw from the explicit ``torch.Generator``
where the JAX package takes a ``key``.
"""

from __future__ import annotations

__all__ = ["Loss", "StackedPhysicsLoss"]


class Loss:
    """Base loss (base.py:20)."""

    def __call__(self, x_net=None, x=None, y=None, physics=None, model=None, generator=None,
                 **kwargs):
        raise NotImplementedError

    def adapt_model(self, model):
        """Optionally wrap the model (base.py:41). Default: no change."""
        return model


class StackedPhysicsLoss(Loss):
    """One loss per member of a stacked physics, on its measurement, summed
    (base.py:46)."""

    def __init__(self, losses):
        self.losses = list(losses)

    def __call__(self, x_net=None, x=None, y=None, physics=None, model=None, generator=None,
                 **kwargs):
        total = 0.0
        for loss, yi, p in zip(self.losses, y, physics.physics_list):
            total = total + loss(x_net=x_net, x=x, y=yi, physics=p, model=model,
                                 generator=generator, **kwargs)
        return total

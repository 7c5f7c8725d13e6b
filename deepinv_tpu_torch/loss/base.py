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

    def __init__(self):
        pass

    def __call__(self, x_net=None, x=None, y=None, physics=None, model=None, generator=None,
                 **kwargs):
        raise NotImplementedError

    def forward(self, x_net=None, x=None, y=None, physics=None, model=None, generator=None,
                **kwargs):
        """The loss, as calling it (base.py:27)."""
        return self(x_net=x_net, x=x, y=y, physics=physics, model=model, generator=generator,
                    **kwargs)

    @property
    def name(self) -> str:
        """The loss's name, deprecated for its class name (base.py:29-39):
        warns, and returns ``_name`` where a loss sets one, else the class
        name."""
        import warnings

        warnings.warn("The attribute 'name' is deprecated in favor of the class name.",
                      DeprecationWarning, stacklevel=2)
        return getattr(self, "_name", type(self).__name__)

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

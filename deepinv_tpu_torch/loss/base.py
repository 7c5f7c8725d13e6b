"""Loss base class (port of deepinv_tpu/loss/base.py).

Signature: ``loss(x_net=..., x=..., y=..., physics=..., model=...,
generator=...)`` returning per-sample values of shape (B,); the trainer
reduces them. Stochastic losses draw from the explicit ``torch.Generator``
where the JAX package takes a ``key``.
"""

from __future__ import annotations

__all__ = ["Loss"]


class Loss:
    """Base loss (base.py:20)."""

    def __call__(self, x_net=None, x=None, y=None, physics=None, model=None, generator=None,
                 **kwargs):
        raise NotImplementedError

    def adapt_model(self, model):
        """Optionally wrap the model (base.py:41). Default: no change."""
        return model

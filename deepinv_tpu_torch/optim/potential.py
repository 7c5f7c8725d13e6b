"""Potential base class (port of deepinv_tpu/optim/potential.py)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Potential"]


class Potential(nn.Module):
    """Anything with ``fn``/``grad``/``prox`` (deepinv_tpu/optim/potential.py:19).
    ``Potential(fn=callable)`` wraps a plain function. ``grad`` defaults to
    autograd of ``fn``; ``prox`` to inner gradient descent."""

    def __init__(self, fn=None):
        super().__init__()
        self._custom_fn = fn

    def fn(self, x, *args, **kwargs):
        if self._custom_fn is not None:
            return self._custom_fn(x, *args, **kwargs)
        raise NotImplementedError

    def forward(self, x, *args, **kwargs):
        return self.fn(x, *args, **kwargs)

    def grad(self, x, *args, **kwargs):
        """Gradient of the potential by autograd (potential.py:36)."""
        with torch.enable_grad():
            u = x.detach().requires_grad_()
            return torch.autograd.grad(self.fn(u, *args, **kwargs).sum(), u)[0]

    def prox(self, x, *args, gamma=1.0, stepsize_inter=1.0, max_iter_inter: int = 50, **kwargs):
        """``prox_{gamma f}(x)`` by inner gradient descent (potential.py:41)."""
        u = x
        for _ in range(max_iter_inter):
            u = u - stepsize_inter * (gamma * self.grad(u, *args, **kwargs) + (u - x))
        return u

    def prox_conjugate(self, x, *args, gamma=1.0, lamb=1.0, **kwargs):
        r"""``prox_{gamma (lamb f)^*}(x) = x - gamma prox_{lamb f / gamma}(x / gamma)``,
        the Moreau identity (potential.py:66)."""
        return x - gamma * self.prox(x / gamma, *args, gamma=lamb / gamma, **kwargs)

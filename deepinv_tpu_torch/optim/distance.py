"""Distances ``d(u, y)`` between an estimated and an observed measurement
(port of deepinv_tpu/optim/distance.py). Each returns one value a sample."""

from __future__ import annotations

import torch

from .potential import Potential, autograd_grad

__all__ = ["Distance", "L2Distance", "IndicatorL2Distance", "PoissonLikelihoodDistance",
           "L1Distance", "AmplitudeLossDistance", "LogPoissonLikelihoodDistance", "ZeroDistance"]


def _batch_sum(v):
    """The sum over every axis but the first: shape ``(B,)``."""
    return v.reshape(v.shape[0], -1).sum(1)


class Distance(Potential):
    """Base distance (deepinv_tpu/optim/distance.py:28); ``Distance(d=callable)``
    wraps a plain ``d(u, y)``. ``grad`` defaults to autograd in ``u``."""

    def __init__(self, d=None):
        super().__init__(fn=d)

    def fn(self, u, y, *args, **kwargs):
        if self._custom_fn is not None:
            return self._custom_fn(u, y, *args, **kwargs)
        raise NotImplementedError

    def forward(self, u, y, *args, **kwargs):
        return self.fn(u, y, *args, **kwargs)

    def grad(self, u, y, *args, **kwargs):
        """``grad_u sum d(u, y)`` by autograd (distance.py:44)."""
        return autograd_grad(lambda v: self.fn(v, y, *args, **kwargs), u)


class L2Distance(Distance):
    r"""``d(u, y) = 1/(2 sigma^2) ||u - y||^2`` (distance.py:48)."""

    def __init__(self, sigma: float = 1.0):
        super().__init__()
        self.norm = 1.0 / sigma ** 2

    def fn(self, u, y, *args, **kwargs):
        return 0.5 * self.norm * _batch_sum((u - y).abs() ** 2)

    def grad(self, u, y, *args, **kwargs):
        return (u - y) * self.norm

    def prox(self, u, y, *args, gamma=1.0, **kwargs):
        """``(u + norm gamma y) / (1 + gamma norm)`` (distance.py:60)."""
        return (u + self.norm * gamma * y) / (1 + gamma * self.norm)


class IndicatorL2Distance(Distance):
    r"""The indicator of the ball ``||u - y|| <= radius`` (distance.py:64)."""

    def __init__(self, radius: float = 1.0):
        super().__init__()
        self.radius = radius

    def fn(self, u, y, *args, radius=None, **kwargs):
        radius = self.radius if radius is None else radius
        dist = torch.sqrt(_batch_sum((u - y).abs() ** 2))
        return torch.where(dist > radius, torch.full_like(dist, float("inf")),
                           torch.zeros_like(dist))

    def prox(self, u, y, *args, radius=None, gamma=None, **kwargs):
        """The projection onto the ball (distance.py:75)."""
        radius = self.radius if radius is None else radius
        diff = u - y
        dist = torch.sqrt(_batch_sum(diff.abs() ** 2))
        dist = dist.reshape(dist.shape + (1,) * (u.dim() - 1))
        scale = torch.clamp(radius / (dist + 1e-12), max=1.0)
        return y + diff * scale


class PoissonLikelihoodDistance(Distance):
    r"""The Poisson negative log-likelihood (distance.py:84):
    ``sum(u/gain + bkg - y) - sum(y log(u/gain + bkg))``, with ``y`` divided
    by ``gain`` first where ``denormalize``. Both sums are per sample, as in
    the JAX package (:93-101)."""

    def __init__(self, gain: float = 1.0, bkg: float = 0.0, denormalize: bool = False):
        super().__init__()
        self.gain = gain
        self.bkg = bkg
        self.denormalize = denormalize

    def fn(self, u, y, *args, **kwargs):
        if self.denormalize:
            y = y / self.gain
        return (_batch_sum(-y * torch.log(u / self.gain + self.bkg))
                + _batch_sum(u / self.gain + self.bkg - y))

    def grad(self, u, y, *args, **kwargs):
        if self.denormalize:
            y = y / self.gain
        return self.gain * (1 - y / (u / self.gain + self.bkg))

    def prox(self, u, y, *args, gamma: float = 1.0, **kwargs):
        """The closed-form prox of ``gamma d(., y)`` at ``u``: the positive
        root of ``g w^2 + (gamma/g - g b - u) w - gamma y / g = 0``, ``w = v/g
        + b`` (distance.py:108). It deviates from upstream on purpose, as the
        JAX package does (ROADMAP Queue 3): upstream's formula returns negative
        values."""
        if self.denormalize:
            y = y / self.gain
        g, b = self.gain, self.bkg
        c = u + g * b - gamma / g
        return (c + torch.sqrt(c ** 2 + 4 * gamma * y)) / 2 - g * b


class L1Distance(Distance):
    r"""``d(u, y) = ||u - y||_1`` with the soft-threshold prox (distance.py:123)."""

    def fn(self, u, y, *args, **kwargs):
        return _batch_sum((u - y).abs())

    def grad(self, u, y, *args, **kwargs):
        return torch.sign(u - y)

    def prox(self, u, y, *args, gamma: float = 1.0, **kwargs):
        d = u - y
        return y + torch.sign(d) * torch.clamp(d.abs() - gamma, min=0.0)


class AmplitudeLossDistance(Distance):
    r"""The phase-retrieval amplitude loss ``||sqrt(u) - sqrt(y)||^2``
    (distance.py:137)."""

    def fn(self, u, y, *args, **kwargs):
        return _batch_sum((torch.sqrt(u) - torch.sqrt(y)) ** 2)

    def grad(self, u, y, *args, epsilon: float = 1e-12, **kwargs):
        return 1 - torch.sqrt(y / (u + epsilon))


class LogPoissonLikelihoodDistance(Distance):
    r"""The log-Poisson negative log-likelihood of CT (distance.py:148):
    ``N0 exp(-mu u) + N0 exp(-mu y) mu u``; its gradient by autograd."""

    def __init__(self, N0: float = 1024.0, mu: float = 1 / 50.0):
        super().__init__()
        self.N0 = N0
        self.mu = mu

    def fn(self, u, y, *args, **kwargs):
        out1 = torch.exp(-u * self.mu) * self.N0
        out2 = torch.exp(-y * self.mu) * self.N0 * (u * self.mu)
        return _batch_sum(out1 + out2)


class ZeroDistance(Distance):
    """Identically zero (distance.py:161)."""

    def fn(self, u, y, *args, **kwargs):
        return u.new_zeros(u.shape[0])

    def grad(self, u, y, *args, **kwargs):
        return torch.zeros_like(u)

    def prox(self, u, y, *args, gamma=1.0, **kwargs):
        return u

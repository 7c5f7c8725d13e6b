"""Supervised and self-supervised losses (port of deepinv_tpu/loss/losses.py).

Stochastic losses draw from an explicit ``torch.Generator`` (the JAX package's
``key``); each also takes its draws as an argument, so that a test can feed
the JAX package's. SURE's divergence is a forward-mode JVP
(``torch.autograd.forward_ad``), as ``jax.jvp`` there (losses.py:241-247):
the train step's backward differentiates it again.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from .base import Loss
from .metric import MSE

__all__ = ["SupLoss", "MCLoss", "EILoss", "SureGaussianLoss"]


def _bmean(v):
    return v.reshape(v.shape[0], -1).mean(1)


class SupLoss(Loss):
    """Supervised loss ``metric(x_net, x)`` (losses.py:46)."""

    def __init__(self, metric=None):
        self.metric = metric if metric is not None else MSE()

    def __call__(self, x_net=None, x=None, **kwargs):
        return self.metric(x_net, x)


class MCLoss(Loss):
    """Measurement consistency ``metric(A(x_net), y)`` (losses.py:71)."""

    def __init__(self, metric=None):
        self.metric = metric if metric is not None else MSE()

    def __call__(self, x_net=None, y=None, physics=None, **kwargs):
        return self.metric(physics.A(x_net), y)


class EILoss(Loss):
    """Equivariant imaging loss ``metric(model(A(T x_net)), T x_net)``
    (losses.py:81).

    :param transform: a :class:`~deepinv_tpu_torch.transform.Transform`.
    :param apply_noise: measure ``T x_net`` with the physics' noise.
    :param no_grad: stop the gradient through ``T x_net``.
    """

    def __init__(self, transform, metric=None, apply_noise: bool = True, weight: float = 1.0,
                 no_grad: bool = False):
        self.T = transform
        self.metric = metric if metric is not None else MSE()
        self.apply_noise = apply_noise
        self.weight = weight
        self.no_grad = no_grad

    def __call__(self, x_net=None, physics=None, model=None, generator=None, params=None,
                 **kwargs):
        """``params``: the transform's parameters, drawn from ``generator``
        if None; the measurement noise is drawn from ``generator`` after them."""
        if params is None:
            params = self.T.get_params(x_net, generator)
        x2 = self.T.transform(x_net, **params)
        if self.no_grad:
            x2 = x2.detach()
        y2 = physics(x2, generator=generator) if self.apply_noise else physics.A(x2)
        return self.weight * self.metric(model(y2, physics), x2)


class SureGaussianLoss(Loss):
    r"""SURE for Gaussian noise (losses.py:187):
    ``1/m ||y - A xhat||^2 - sigma^2 + 2 sigma^2 / m div``, with the
    Hutchinson divergence ``b . J b`` of ``y -> A(model(y))`` by a
    forward-mode JVP. ``x_net`` is not used: the JVP's primal is the
    reconstruction.

    A model op without a forward-mode derivative (the DnCNN chain's kernel op,
    like the JAX ``custom_vjp``) raises here: run SURE with the kernel gates
    closed (``fused_chains_disabled()``, ``Trainer(fused_chains=False)``).
    """

    def __init__(self, sigma: float):
        self.sigma2 = sigma ** 2

    def __call__(self, y=None, physics=None, model=None, x_net=None, generator=None,
                 probe=None, **kwargs):
        """``probe``: the Hutchinson probe ``b``, drawn N(0, I) from
        ``generator`` if None."""
        b = probe if probe is not None else torch.randn(
            y.shape, generator=generator, device=y.device, dtype=y.dtype)
        with fwAD.dual_level():
            out = physics.A(model(fwAD.make_dual(y, b), physics))
            y1, jvp_b = fwAD.unpack_dual(out)
        div = 2 * self.sigma2 * _bmean(b * jvp_b)
        return _bmean((y1 - y) ** 2) + div - self.sigma2

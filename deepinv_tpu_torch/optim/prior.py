"""Priors ``g(x)`` (port of deepinv_tpu/optim/prior.py): the base, ``Zero``,
the Plug-and-Play prior, the score prior of the Langevin samplers,
Tikhonov and isotropic total variation. RED, ``TVL1Prior`` and the sparsity
priors wait for ROADMAP queue 1 item 8."""

from __future__ import annotations

import torch

from ..ops.kernels.tv import chambolle_prox, chambolle_prox_plain
from ..ops.kernels.tv import div_op as _div_op
from ..ops.kernels.tv import grad_op as _grad_op
from .potential import Potential

__all__ = ["Prior", "Zero", "PnP", "ScorePrior", "Tikhonov", "TVPrior"]


def _batch_sum(v):
    return v.reshape(v.shape[0], -1).sum(1)


class Prior(Potential):
    r"""Base prior (deepinv_tpu/optim/prior.py:35). ``explicit_prior`` marks
    priors with a cost function; ``Prior(g=callable)`` wraps one."""

    explicit_prior = True

    def __init__(self, g=None):
        super().__init__(fn=g)


class Zero(Prior):
    r"""``g(x) = 0`` (prior.py:55)."""

    def fn(self, x, *args, **kwargs):
        return x.new_zeros(x.shape[0])

    def grad(self, x, *args, **kwargs):
        return torch.zeros_like(x)

    def prox(self, x, *args, gamma=1.0, **kwargs):
        return x


class PnP(Prior):
    r"""Plug-and-Play prior: the prox is a denoiser (prior.py:68)."""

    explicit_prior = False

    def __init__(self, denoiser):
        super().__init__()
        self.denoiser = denoiser

    def prox(self, x, sigma_denoiser, *args, gamma=None, **kwargs):
        return self.denoiser(x, sigma_denoiser)


class ScorePrior(Prior):
    r"""Score prior by Tweedie's formula: ``grad g(x) = (x - D(x, sigma)) /
    sigma^2`` for a denoiser ``D`` (deepinv_tpu/optim/prior.py:103); the prior
    of :class:`~deepinv_tpu_torch.sampling.ULA` and
    :class:`~deepinv_tpu_torch.sampling.SKRock`."""

    explicit_prior = False

    def __init__(self, denoiser):
        super().__init__()
        self.denoiser = denoiser

    def grad(self, x, sigma_denoiser, *args, **kwargs):
        return (1 / sigma_denoiser ** 2) * (x - self.denoiser(x, sigma_denoiser))

    def score(self, x, sigma_denoiser, *args, **kwargs):
        """``-grad g(x)``, the score of the prior (prior.py:115)."""
        return -self.grad(x, sigma_denoiser, *args, **kwargs)

    @staticmethod
    def stable_division(a, b, epsilon: float = 1e-7):
        """``a / b`` with the denominator pushed away from zero (prior.py:119)."""
        if isinstance(b, (int, float)):
            return a / (max(epsilon, abs(b)) * (1.0 if b >= 0 else -1.0))
        b = torch.as_tensor(b)
        sign = torch.where(b >= 0, 1.0, -1.0)
        return a / torch.where(b.abs() > epsilon, b, sign * epsilon)


class Tikhonov(Prior):
    r"""``g(x) = 1/2 ||x||^2`` (deepinv_tpu/optim/prior.py:130)."""

    def fn(self, x, *args, **kwargs):
        return 0.5 * _batch_sum(x.abs() ** 2)

    def grad(self, x, *args, **kwargs):
        return x

    def prox(self, x, *args, gamma=1.0, **kwargs):
        return x / (1 + gamma)


class TVPrior(Prior):
    r"""Isotropic total variation (deepinv_tpu/optim/prior.py:187), with the
    prox by Chambolle's dual projection.

    :param n_it_max: Chambolle iterations of :meth:`prox`.
    :param use_pallas: the JAX package's switch, kept under its name.
        ``None`` (default) or ``True``: :meth:`prox` runs
        :func:`~deepinv_tpu_torch.ops.kernels.tv.chambolle_prox`, the CUDA
        kernel on a GPU tensor and the plain version on a CPU tensor.
        ``False``: the plain version on any device.
    """

    def __init__(self, n_it_max: int = 100, use_pallas: bool | None = None):
        super().__init__()
        self.n_it_max = n_it_max
        self.use_pallas = use_pallas

    @staticmethod
    def nabla(x):
        """Finite-difference gradient (prior.py:205)."""
        from ..models.classic import _TVOpsMixin

        return _TVOpsMixin.nabla(x)

    @staticmethod
    def nabla_adjoint(u):
        """Adjoint of :meth:`nabla` (prior.py:212)."""
        from ..models.classic import _TVOpsMixin

        return _TVOpsMixin.nabla_adjoint(u)

    def fn(self, x, *args, **kwargs):
        """``sum sqrt(|grad x|^2 + 1e-12)`` per sample (prior.py:218)."""
        g = _grad_op(x)
        return _batch_sum(torch.sqrt((g * g).sum(-1) + 1e-12))

    def prox(self, x, *args, gamma=1.0, **kwargs):
        """Prox of ``gamma * TV`` by ``n_it_max`` Chambolle steps
        (prior.py:223)."""
        if self.use_pallas is False:
            return chambolle_prox_plain(x, gamma, self.n_it_max)
        return chambolle_prox(x, gamma, self.n_it_max)

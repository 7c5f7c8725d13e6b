"""Priors ``g(x)`` (port of deepinv_tpu/optim/prior.py): the base, ``Zero``,
the Plug-and-Play and RED priors, the score prior of the Langevin samplers,
Tikhonov, the l1, group l1-l2 and wavelet sparsity priors, isotropic total
variation and TV-L1."""

from __future__ import annotations

import torch

from ..ops.kernels.tv import chambolle_prox, chambolle_prox_plain
from ..ops.kernels.tv import div_op as _div_op
from ..ops.kernels.tv import grad_op as _grad_op
from ..utils.profiling import PRIOR
from .potential import Potential

__all__ = ["Prior", "Zero", "PnP", "RED", "ScorePrior", "Tikhonov", "L1Prior", "L12Prior",
           "TVPrior", "TVL1Prior", "WaveletPrior"]


def _batch_sum(v):
    return v.reshape(v.shape[0], -1).sum(1)


class Prior(Potential):
    r"""Base prior (deepinv_tpu/optim/prior.py:35). ``explicit_prior`` marks
    priors with a cost function; ``Prior(g=callable)`` wraps one."""

    explicit_prior = True
    span_name = PRIOR

    def __init__(self, g=None):
        super().__init__(fn=g)

    def grad(self, x, sigma_denoiser=None, *args, **kwargs):
        """``grad_x g(x, sigma_denoiser, ...)`` by autograd (prior.py:51);
        ``g(x)`` alone where ``sigma_denoiser`` is None and nothing follows."""
        if sigma_denoiser is not None or args:
            args = (sigma_denoiser,) + args
        return super().grad(x, *args, **kwargs)


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


class RED(Prior):
    r"""Regularization by denoising: ``grad g(x) = x - D(x, sigma)`` for a
    denoiser ``D`` (prior.py:91)."""

    explicit_prior = False

    def __init__(self, denoiser):
        super().__init__()
        self.denoiser = denoiser

    def grad(self, x, sigma_denoiser, *args, **kwargs):
        return x - self.denoiser(x, sigma_denoiser)


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


class L1Prior(Prior):
    r"""``g(x) = ||x||_1`` with the soft-threshold prox (prior.py:143)."""

    def fn(self, x, *args, **kwargs):
        return _batch_sum(x.abs())

    def prox(self, x, *args, gamma=1.0, **kwargs):
        return torch.sign(x) * torch.clamp(x.abs() - gamma, min=0.0)


class L12Prior(Prior):
    r"""The group l1-l2 norm, the l2 norm over ``l2_axis`` summed
    (prior.py:153); its prox scales each group by ``relu(n - gamma) / (n +
    1e-12)``."""

    def __init__(self, l2_axis: int = -1):
        super().__init__()
        self.l2_axis = l2_axis

    def fn(self, x, *args, **kwargs):
        n = torch.sqrt((x ** 2).sum(self.l2_axis))
        return n.abs().reshape(n.shape[0], -1).sum(-1)

    def prox(self, x, *args, gamma=1.0, **kwargs):
        n = torch.sqrt((x ** 2).sum(self.l2_axis, keepdim=True))
        return x * (torch.clamp(n - gamma, min=0.0) / (n + 1e-12))


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


class WaveletPrior(Prior):
    r"""``g(x) = ||W x||_1`` over the detail coefficients of an orthonormal
    DWT (prior.py:248), on :class:`~deepinv_tpu_torch.ops.wavelets.WaveletTransform`;
    the prox soft-thresholds the details, ``W^T soft(W x)``."""

    def __init__(self, wv: str = "db4", level: int = 3, p: int = 1, wvdim: int = 2):
        from ..ops.wavelets import WaveletTransform

        super().__init__()
        self.wt = WaveletTransform(wavelet=wv, level=level, ndim=wvdim)
        self.p = p

    def fn(self, x, *args, **kwargs):
        return _batch_sum(self.wt.flat_coeffs(self.wt.dwt2(x)).abs())

    def prox(self, x, *args, gamma=1.0, **kwargs):
        coeffs = self.wt.map_detail(
            self.wt.dwt2(x), lambda c: torch.sign(c) * torch.clamp(c.abs() - gamma, min=0.0))
        return self.wt.idwt2(coeffs)

    def psi(self, x, *args, **kwargs):
        """The coefficient arrays, approximation first (prior.py:272)."""
        dec = self.wt.dwt2(x)
        return [dec["coeffs"][0]] + [c for d in dec["coeffs"][1:] for c in d]


class TVL1Prior(Prior):
    r"""Anisotropic TV, ``sum |grad x|_1`` (prior.py:282), with the prox by
    the TV-L1 primal-dual denoiser
    (:class:`~deepinv_tpu_torch.models.TVL1Denoiser`) at threshold ``gamma``,
    as in the JAX package; not Chambolle's prox (no K7)."""

    def __init__(self, n_it_max: int = 100):
        super().__init__()
        self.n_it_max = n_it_max

    nabla = staticmethod(TVPrior.nabla)
    nabla_adjoint = staticmethod(TVPrior.nabla_adjoint)

    def fn(self, x, *args, **kwargs):
        return _batch_sum(_grad_op(x).abs().sum(-1))

    def prox(self, x, *args, gamma=1.0, **kwargs):
        from ..models.classic import TVL1Denoiser

        return TVL1Denoiser(self.n_it_max)(x, ths=gamma)

"""Noise models (port of deepinv_tpu/physics/noise.py).

Randomness is a ``torch.Generator`` passed as ``generator=``, in place of the
JAX package's ``key=``. With ``generator=None`` a generator seeded from the
model's ``seed`` is used, so a draw is reproducible like the JAX package's
``ensure_key(key, seed)`` (noise.py:59). Each model takes its draws from a
:class:`~deepinv_tpu_torch.core.rng.Draws` in a fixed order (that of the JAX
model's key splits); the keyword ``draws=`` hands it the draws themselves,
which only the parity tests do.

Each parameter is a scalar or a per-sample ``(B,)`` tensor, kept as a float32
buffer on ``device`` (the CUDA device by default) and broadcast over the
measurement's trailing dimensions (``_bcast``, noise.py:42). ``update`` (and
``update_parameters``) returns a new model with parameters replaced, so a
generator's ``(B,)`` levels reach the model through ``Physics.update``.
Models chain: ``(n1 * n2)(y) == n1(n2(y))``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device
from .base import replace, update

__all__ = ["NoiseModel", "ZeroNoise", "GaussianNoise", "UniformGaussianNoise", "PoissonNoise",
           "GammaNoise", "PoissonGaussianNoise", "UniformNoise", "LogPoissonNoise",
           "SaltPepperNoise", "FisherTippettNoise", "RicianNoise", "LaplaceNoise"]


def _bcast(param: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or (B,)-shaped parameter over x's trailing dims
    (noise.py:42)."""
    if param.dim() == 0:
        return param
    return param.reshape(param.shape + (1,) * (x.dim() - param.dim()))


class NoiseModel(nn.Module):
    """Base noise model (deepinv_tpu/physics/noise.py:50): identity.

    :param seed: the seed of the generator a call without one draws from.
    :param device: where the parameters live (subclasses); the CUDA device by
        default.
    """

    def __init__(self, seed: int = 0, device=None):
        super().__init__()
        self.seed = seed
        self._device = device

    def _param(self, name: str, value):
        """Register ``value`` as the float32 buffer ``name`` on the model's
        device."""
        self.register_buffer(name, torch.as_tensor(value, dtype=torch.float32).to(
            resolve_device(self._device)))

    def sample(self, y, draws: Draws):
        return y

    def forward(self, y, generator=None, *, draws=None):
        """``y`` with noise drawn from ``generator`` (seeded from ``seed`` if
        None); ``draws`` hands in the draws themselves."""
        return self.sample(y, Draws(generator, self.seed, y.device, draws))

    def __mul__(self, other: "NoiseModel") -> "NoiseModel":
        """Chained noise ``(n1 * n2)(y) = n1(n2(y))`` (noise.py:66)."""
        return _ChainedNoise(self, other)

    def update(self, **params):
        """A copy with the known parameters replaced
        (:func:`deepinv_tpu_torch.physics.base.update`)."""
        return update(self, **params)

    def update_parameters(self, **params):
        """The reference's name of :meth:`update` (noise.py:89)."""
        return self.update(**params)

    def rng_manual_seed(self, seed: int) -> "NoiseModel":
        """A copy whose calls without a generator draw from ``seed``
        (noise.py:70)."""
        return replace(self, seed=seed)

    def reset_rng(self) -> "NoiseModel":
        """The model itself (noise.py:74): a call without a generator seeds a
        fresh one from ``seed``, so it always repeats its draws."""
        return self

    def rand_like(self, y, generator=None):
        """Uniform [0, 1) draws shaped like ``y`` (noise.py:80)."""
        return Draws(generator, self.seed, y.device).uniform(y.shape, y.dtype)

    def randn_like(self, y, generator=None):
        """Standard normal draws shaped like ``y`` (noise.py:85)."""
        return Draws(generator, self.seed, y.device).normal(y.shape, y.dtype)


class _ChainedNoise(NoiseModel):
    """``outer(inner(y))`` (noise.py:94): the inner model draws first."""

    def __init__(self, outer: NoiseModel, inner: NoiseModel):
        super().__init__()
        self.outer = outer
        self.inner = inner

    def sample(self, y, draws):
        return self.outer.sample(self.inner.sample(y, draws), draws)


class ZeroNoise(NoiseModel):
    """No noise (noise.py:105)."""


class GaussianNoise(NoiseModel):
    r"""``y = x + sigma * eps``, eps ~ N(0, I) (noise.py:112); complex
    measurements get circular complex noise (a real and an imaginary draw).
    """

    def __init__(self, sigma=0.1, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("sigma", sigma)

    def sample(self, y, draws):
        s = _bcast(self.sigma, y)
        if y.is_complex():
            rdt = y.real.dtype
            eps = torch.complex(draws.normal(y.shape, rdt), draws.normal(y.shape, rdt))
        else:
            eps = draws.normal(y.shape, y.dtype)
        return y + s * eps

    def __mul__(self, other):
        """Two Gaussians merge in closed form, a number or tensor scales
        sigma (noise.py:150), any other model chains."""
        if isinstance(other, GaussianNoise):
            return GaussianNoise((self.sigma ** 2 + other.sigma ** 2) ** 0.5,
                                 device=self.sigma.device)
        if isinstance(other, (int, float, torch.Tensor)):
            return GaussianNoise(self.sigma * other, device=self.sigma.device)
        return super().__mul__(other)


class UniformGaussianNoise(NoiseModel):
    r"""Gaussian noise with a level ``sigma ~ U(sigma_min, sigma_max)`` drawn
    per sample (noise.py:161)."""

    def __init__(self, sigma_min=0.0, sigma_max=0.5, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("sigma_min", sigma_min)
        self._param("sigma_max", sigma_max)

    def sample(self, y, draws):
        u = draws.uniform((y.shape[0],), y.dtype)
        sigma = self.sigma_min + u * (self.sigma_max - self.sigma_min)
        return y + _bcast(sigma, y) * draws.normal(y.shape, y.dtype)


class PoissonNoise(NoiseModel):
    r"""``y = gain * P(x / gain)`` (noise.py:180).

    :param gain: the inverse photon-count scale.
    :param normalize: multiply the counts back by ``gain``.
    :param clip_positive: clip ``x / gain`` at 0 before sampling.
    """

    def __init__(self, gain=1.0, normalize: bool = True, clip_positive: bool = False,
                 seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("gain", gain)
        self.normalize = normalize
        self.clip_positive = clip_positive

    def sample(self, y, draws):
        g = _bcast(self.gain, y)
        rate = (y / g).broadcast_to(y.shape)
        if self.clip_positive:
            rate = rate.clamp_min(0.0)
        z = draws.poisson(rate.contiguous()).to(y.dtype)
        return z * g if self.normalize else z


class GammaNoise(NoiseModel):
    r"""``y ~ Gamma(l, x / l)``, of mean ``x`` (noise.py:205)."""

    def __init__(self, l=1.0, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("l", l)

    def sample(self, y, draws):
        l = _bcast(self.l, y)
        g = draws.gamma(l.to(y.dtype).broadcast_to(y.shape).contiguous())
        return g * y / l


class PoissonGaussianNoise(NoiseModel):
    r"""``y = gain * P(x / gain) + sigma * eps`` (noise.py:219)."""

    def __init__(self, gain=1.0, sigma=0.1, clip_positive: bool = False, seed: int = 0,
                 device=None):
        super().__init__(seed=seed, device=device)
        self._param("gain", gain)
        self._param("sigma", sigma)
        self.clip_positive = clip_positive

    def sample(self, y, draws):
        g = _bcast(self.gain, y)
        rate = (y / g).broadcast_to(y.shape)
        if self.clip_positive:
            rate = rate.clamp_min(0.0)
        z = draws.poisson(rate.contiguous()).to(y.dtype) * g
        return z + _bcast(self.sigma, y) * draws.normal(y.shape, y.dtype)


class UniformNoise(NoiseModel):
    r"""``y = x + eps``, eps ~ U(-a, a) (noise.py:239)."""

    def __init__(self, a=0.1, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("a", a)

    def sample(self, y, draws):
        return y + (draws.uniform(y.shape, y.dtype) * 2.0 - 1.0) * _bcast(self.a, y)


class LogPoissonNoise(NoiseModel):
    r"""``y = -log(P(exp(-mu x) N0) / N0) / mu``, the Beer-Lambert noise of
    CT (noise.py:251)."""

    def __init__(self, N0=1024.0, mu=1 / 50.0, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("N0", N0)
        self._param("mu", mu)

    def sample(self, y, draws):
        N0, mu = _bcast(self.N0, y), _bcast(self.mu, y)
        n1 = draws.poisson((N0 * torch.exp(-y * mu)).broadcast_to(y.shape).contiguous())
        return -torch.log(n1.to(y.dtype).clamp_min(1e-8) / N0) / mu


class SaltPepperNoise(NoiseModel):
    r"""Salt and pepper: a pixel becomes 0 with probability ``p`` and 1 with
    probability ``s`` (noise.py:267)."""

    def __init__(self, p=0.025, s=0.025, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("p", p)
        self._param("s", s)

    def sample(self, y, draws):
        z = draws.uniform(y.shape, y.dtype)
        out = torch.where(z < _bcast(self.p, y), torch.zeros_like(y), y)
        return torch.where(z > 1 - _bcast(self.s, y), torch.ones_like(y), out)


class FisherTippettNoise(NoiseModel):
    r"""``y = log(Gamma(l, exp(x) / l))``, speckle in the log domain
    (noise.py:284): the inputs are log-intensities."""

    def __init__(self, l=1.0, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("l", l)

    def sample(self, y, draws):
        l = _bcast(self.l, y)
        g = draws.gamma(l.to(y.dtype).broadcast_to(y.shape).contiguous())
        return torch.log((g * torch.exp(y) / l).clamp_min(1e-20))


class RicianNoise(NoiseModel):
    r"""``y = sqrt((x + sigma e1)^2 + (sigma e2)^2)`` (noise.py:300)."""

    def __init__(self, sigma=0.1, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("sigma", sigma)

    def sample(self, y, draws):
        s = _bcast(self.sigma, y)
        n1 = draws.normal(y.shape, y.dtype)
        n2 = draws.normal(y.shape, y.dtype)
        return torch.sqrt((y + s * n1) ** 2 + (s * n2) ** 2)


class LaplaceNoise(NoiseModel):
    r"""``y = x + eps``, eps ~ Laplace(0, b) (noise.py:315)."""

    def __init__(self, b=0.1, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self._param("b", b)

    def sample(self, y, draws):
        return y + draws.laplace(y.shape, y.dtype) * _bcast(self.b, y)

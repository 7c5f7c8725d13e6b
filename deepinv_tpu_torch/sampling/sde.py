"""SDEs for generation and posterior sampling (port of
deepinv_tpu/sampling/sde.py).

:class:`BaseSDE` holds a drift and a diffusion; the solvers (Euler-Maruyama,
Heun) step over a time grid. :class:`PosteriorDiffusion` adds a noisy
data-fidelity guidance (:class:`DPSDataFidelity`, autograd through the
denoiser with its weights frozen) to a reverse-time diffusion's drift.

The port evaluates the schedules on the host: a time ``t`` is a 0-d float64
CPU tensor, so ``sigma_t(t)`` and the drift's coefficients are host numbers
that enter the device's arithmetic as scalars, and a step reads nothing back
from the device. A derivative the caller does not supply is taken by
autograd on the host, where the JAX package takes ``jax.grad``. Randomness is
a ``torch.Generator`` (or the draws of a parity test), not the JAX solver's
draw counter (sde.py:86-99).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device
from ..models.base import Reconstructor
from ..optim.data_fidelity import DataFidelity
from .utils import frozen

__all__ = ["BaseSDE", "BaseSDESolver", "EulerSolver", "HeunSolver", "DiffusionSDE",
           "VarianceExplodingDiffusion", "VariancePreservingDiffusion", "EDMDiffusionSDE",
           "SongDiffusionSDE", "FlowMatching", "NoisyDataFidelity", "DPSDataFidelity",
           "PosteriorDiffusion"]


def _t(t) -> torch.Tensor:
    """A time as a 0-d float64 CPU tensor."""
    return torch.as_tensor(t, dtype=torch.float64)


def _derivative(f: Callable) -> Callable:
    """``t -> f'(t)`` by autograd on the host (the JAX package's ``jax.grad``)."""
    def df(t):
        with torch.enable_grad():
            u = _t(t).detach().requires_grad_()
            v = _t(f(u)).sum()
            if not v.requires_grad:  # f does not depend on t
                return torch.zeros_like(u)
            (d,) = torch.autograd.grad(v, u, allow_unused=True)
        return torch.zeros_like(u) if d is None else d
    return df


def _interp(t, xp, fp):
    """Piecewise-linear interpolation of ``(xp, fp)`` at the 0-d ``t``,
    differentiable in ``t`` and constant outside ``xp``, as ``jnp.interp``."""
    i = int(torch.searchsorted(xp, t.detach().reshape(1), right=True)[0].clamp(1, len(xp) - 1))
    if t < xp[0]:
        return fp[0]
    if t > xp[-1]:
        return fp[-1]
    return fp[i - 1] + (t - xp[i - 1]) / (xp[i] - xp[i - 1]) * (fp[i] - fp[i - 1])


class BaseSDE(nn.Module):
    r"""``dx = f(x, t) dt + g(t) dw`` (deepinv_tpu/sampling/sde.py:37).

    :param drift: ``f(x, t)``.
    :param diffusion: ``g(t)``.
    """

    def __init__(self, drift: Callable, diffusion: Callable):
        super().__init__()
        self.drift = drift
        self.diffusion = diffusion

    def sample_init(self, shape, generator=None, seed: int = 0, device=None, draws=None):
        """A draw from the end-time distribution; concrete SDEs define it."""
        raise NotImplementedError

    def discretize(self, x, t, dt, normal=None):
        return self.drift(x, t), self.diffusion(t)

    def sample(self, x_init, solver: "BaseSDESolver", generator=None, seed: int = 0, draws=None):
        """Integrate from ``x_init`` with ``solver`` (sde.py:70)."""
        return solver.sample(self, x_init, generator=generator, seed=seed, draws=draws)


class BaseSDESolver(nn.Module):
    """Base SDE solver (sde.py:76): the time grid, one :meth:`step` and the
    loop over the grid in :meth:`sample`.

    :param timesteps: the time grid (decreasing for a reverse-time SDE).
    :param rng_seed: the seed of :meth:`randn_like`'s own generator.
    """

    def __init__(self, timesteps, rng_seed: int = 0):
        super().__init__()
        self.timesteps = np.asarray(timesteps, np.float32)
        self.rng_seed = rng_seed
        self.initial_rng_seed = rng_seed
        self._generator = None

    def randn_like(self, x, generator=None):
        """A standard normal tensor like ``x``, from ``generator`` or else
        from the solver's own generator (seeded from ``rng_seed``), whose
        successive draws differ, as the reference's stateful generator's."""
        if generator is None:
            if self._generator is None or self._generator.device != x.device:
                self._generator = torch.Generator(device=x.device).manual_seed(self.rng_seed)
            generator = self._generator
        return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)

    def rng_manual_seed(self, seed=None):
        """Seed the solver's own generator (sde.py:100); a string seed is hashed."""
        if seed is not None:
            if isinstance(seed, str):
                import hashlib

                seed = int(hashlib.sha256(seed.encode()).hexdigest()[:8], 16)
            self.rng_seed = int(seed)
            self._generator = None
        return self

    def reset_rng(self):
        """Back to the seed given at construction (sde.py:111)."""
        self.rng_seed = self.initial_rng_seed
        self._generator = None
        return self

    def step(self, sde, x, t, dt, normal):
        """One step from ``t`` to ``t + dt``."""
        raise NotImplementedError

    def sample(self, sde, x_init, generator=None, seed: int = 0, draws=None):
        """:meth:`step` over the grid, one normal draw a step (sde.py:122).

        :param generator: ``torch.Generator`` on ``x_init``'s device (seeded
            from ``seed`` if None). :param draws: the draws in order
            (:class:`~deepinv_tpu_torch.core.rng.Draws`).
        """
        normal = Draws.of(generator, seed, draws)
        ts = self.timesteps
        x = x_init
        for t, dt in zip(ts[:-1], ts[1:] - ts[:-1]):  # dt in float32, as the JAX grid
            x = self.step(sde, x, _t(float(t)), float(dt), normal)
        return x


class EulerSolver(BaseSDESolver):
    """Euler-Maruyama (sde.py:137)."""

    def step(self, sde, x, t, dt, normal):
        z = normal.like(x)
        return x + sde.drift(x, t) * dt + sde.diffusion(t) * math.sqrt(abs(dt)) * z


class HeunSolver(BaseSDESolver):
    """Heun's second-order stochastic solver (sde.py:147)."""

    def step(self, sde, x, t, dt, normal):
        z = normal.like(x)
        noise = sde.diffusion(t) * math.sqrt(abs(dt)) * z
        f1 = sde.drift(x, t)
        x_pred = x + f1 * dt + noise
        f2 = sde.drift(x_pred, t + dt)
        return x + 0.5 * (f1 + f2) * dt + noise


class DiffusionSDE(BaseSDE):
    r"""Reverse-time diffusion whose score comes from a denoiser by Tweedie's
    formula (sde.py:160): per ``|dt|`` the drift is ``(1 + alpha)/2 g^2
    score`` and the noise ``sqrt(alpha) g``, ``g^2 = 2 sigma sigma'``
    (``alpha = 0`` is the probability-flow ODE).

    :param denoiser: ``denoiser(x, sigma)``.
    :param sigma_t: ``t -> sigma(t)``.
    :param sigma_deriv: ``t -> sigma'(t)``.
    :param alpha: a number or ``t -> alpha(t)``.
    """

    def __init__(self, denoiser, sigma_t: Callable, sigma_deriv: Callable, alpha=1.0):
        def drift(x, t):
            return (-(1 + self.alpha(t)) * _t(self.sigma_t(t)) * _t(self.sigma_deriv(t))
                    * self.score(x, t))

        def diffusion(t):
            return (2 * self.alpha(t) * _t(self.sigma_t(t))
                    * _t(self.sigma_deriv(t))).clamp_min(0).sqrt()

        super().__init__(drift, diffusion)
        self.denoiser = denoiser
        self.sigma_t = sigma_t
        self.sigma_deriv = sigma_deriv
        self.alpha = alpha if callable(alpha) else (lambda t, a=alpha: a)

    def sigma_t(self, t):
        """The noise schedule ``sigma(t)`` (sde.py:169): the protocol's
        declaration, replaced in each instance by the constructor's
        ``sigma_t``."""
        raise NotImplementedError

    def sample_init(self, shape, generator=None, seed: int = 0, device=None, draws=None):
        """A draw from the prior at the first (largest-noise) time (sde.py:164)."""
        return self.prior_sample(shape, generator=generator, seed=seed, device=device,
                                 draws=draws)

    def score(self, x, t):
        s = _t(self.sigma_t(t))
        return (self.denoiser(x, s) - x) / (s ** 2).clamp_min(1e-8)

    def scale_t(self, t):
        """The state's scale (1 here; ``sqrt(alpha_bar)`` for VP): the
        guidance's denoiser sees ``x / scale_t`` (sde.py:207)."""
        return _t(1.0)


def _prior_normal(shape, generator, seed, device, draws):
    device = resolve_device(device)
    return Draws.of(generator, seed, draws).normal(tuple(shape), torch.float32, device)


class VarianceExplodingDiffusion(DiffusionSDE):
    r"""VE SDE, ``sigma(t) = sigma_min (sigma_max / sigma_min)^t`` (sde.py:214)."""

    def __init__(self, denoiser, sigma_min: float = 0.02, sigma_max: float = 10.0, alpha=0.25):
        ratio = sigma_max / sigma_min
        super().__init__(denoiser, lambda t: sigma_min * ratio ** _t(t),
                         lambda t: sigma_min * ratio ** _t(t) * math.log(ratio), alpha=alpha)
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def prior_sample(self, shape, generator=None, seed: int = 0, device=None, draws=None):
        """``sigma_max`` times a standard normal draw (sde.py:228); ``device``
        is the CUDA device by default."""
        return _prior_normal(shape, generator, seed, device, draws) * self.sigma_max


class VariancePreservingDiffusion(DiffusionSDE):
    r"""VP (DDPM) SDE with a linear ``beta(t)`` (sde.py:232); its denoiser
    sees the state divided by ``sqrt(alpha_bar(t))``."""

    def __init__(self, denoiser, beta_min: float = 0.1, beta_max: float = 20.0):
        BaseSDE.__init__(self, self._drift, self._diffusion)
        self.denoiser = denoiser
        self.beta_min = beta_min
        self.beta_max = beta_max

    def _beta(self, t):
        return self.beta_min + _t(t) * (self.beta_max - self.beta_min)

    def _alpha_bar(self, t):
        t = _t(t)
        return torch.exp(-0.5 * t ** 2 * (self.beta_max - self.beta_min) - t * self.beta_min)

    def _drift(self, x, t):
        b, ab = self._beta(t), self._alpha_bar(t)
        sigma = ((1 - ab).clamp_min(1e-8) / ab.clamp_min(1e-8)).sqrt()
        x0 = self.denoiser(x / ab.clamp_min(1e-8).sqrt(), sigma)
        score = (ab.sqrt() * x0 - x) / (1 - ab).clamp_min(1e-8)
        return -0.5 * b * x - b * score  # the reverse drift

    def _diffusion(self, t):
        return self._beta(t).sqrt()

    def sigma_t(self, t):
        ab = self._alpha_bar(t)
        return ((1 - ab).clamp_min(1e-8) / ab.clamp_min(1e-8)).sqrt()

    def scale_t(self, t):
        return self._alpha_bar(t).clamp_min(1e-8).sqrt()

    def prior_sample(self, shape, generator=None, seed: int = 0, device=None, draws=None):
        """A standard normal draw (sde.py:269)."""
        return _prior_normal(shape, generator, seed, device, draws)


class EDMDiffusionSDE(DiffusionSDE):
    r"""Karras-style SDE with scale and noise schedules (sde.py:273):
    ``dx = (s'/s x - (1 + alpha) s^2 sigma sigma' score) dt + s sqrt(2 alpha
    sigma sigma') dw``, solved in reverse time. ``variance_preserving`` sets
    ``s = (1 + sigma^2)^(-1/2)``, ``variance_exploding`` ``s = 1``; a
    derivative not given is taken by autograd.
    """

    def __init__(self, sigma_t: Callable, scale_t: Callable = None,
                 sigma_prime_t: Callable = None, scale_prime_t: Callable = None,
                 variance_preserving: bool = False, variance_exploding: bool = False,
                 alpha=1.0, T: float = 1.0, denoiser=None):
        if scale_t is None:
            if variance_preserving:
                def scale_t(t):
                    return (1 + sigma_t(t) ** 2) ** -0.5
            elif variance_exploding:
                def scale_t(t):
                    return torch.ones((), dtype=torch.float64)
            else:
                raise ValueError("provide scale_t or set a variance_* flag")
        BaseSDE.__init__(self, self._drift, self._diffusion)
        self.denoiser = denoiser
        self.T = T
        self.sigma_t = sigma_t
        self.scale_t = scale_t
        self.sigma_prime_t = sigma_prime_t or _derivative(sigma_t)
        self.scale_prime_t = scale_prime_t or _derivative(scale_t)
        self.alpha = alpha if callable(alpha) else (lambda t, a=alpha: a)

    def _drift(self, x, t):
        sc, sp = _t(self.scale_t(t)), _t(self.scale_prime_t(t))
        sg, sgp = _t(self.sigma_t(t)), _t(self.sigma_prime_t(t))
        return (sp / sc) * x - (1 + self.alpha(t)) * sc ** 2 * sg * sgp * self.score(x, t)

    def _diffusion(self, t):
        sc = _t(self.scale_t(t))
        return sc * (2 * self.alpha(t) * _t(self.sigma_t(t))
                     * _t(self.sigma_prime_t(t))).clamp_min(0).sqrt()

    def score(self, x, t):
        """Tweedie on the de-scaled state: ``(D(x/s, sigma) - x/s) / (s sigma^2)``."""
        sc, sg = _t(self.scale_t(t)), _t(self.sigma_t(t))
        u = x / sc
        return (self.denoiser(u, sg) - u) / (sc * sg ** 2).clamp_min(1e-12)

    def prior_sample(self, shape, generator=None, seed: int = 0, device=None, draws=None):
        """A normal draw of standard deviation ``s(T) sigma(T)`` (sde.py:329)."""
        sT = float(_t(self.scale_t(self.T)) * _t(self.sigma_t(self.T)))
        return _prior_normal(shape, generator, seed, device, draws) * sT


class SongDiffusionSDE(EDMDiffusionSDE):
    r"""Song et al. (2021) (sde.py:334): forward ``dx = -1/2 beta(t) x dt +
    sqrt(xi(t)) dw`` in the EDM parametrization, ``s(t) = exp(-B(t)/2)``,
    ``sigma(t) = sqrt(int_0^t xi / s^2)``; ``B`` and the variance integral by
    the trapezoid rule on ``n_quad`` points of [0, T], interpolated linearly.
    """

    def __init__(self, beta_t: Callable = None, B_t: Callable = None, xi_t: Callable = None,
                 variance_preserving: bool = False, variance_exploding: bool = False, alpha=1.0,
                 T: float = 1.0, denoiser=None, n_quad: int = 257):
        if variance_preserving:
            if beta_t is None:
                def beta_t(t):
                    return 0.1 + t * (20.0 - 0.1)
            xi_t = beta_t
        if variance_exploding:
            def beta_t(t):
                return torch.zeros((), dtype=torch.float64)
            if xi_t is None:
                raise ValueError("variance_exploding needs xi_t")
        if beta_t is None or xi_t is None:
            raise ValueError("provide beta_t and xi_t (or a variance_* flag)")
        grid = torch.linspace(0.0, T, n_quad, dtype=torch.float64)

        def cumint(f):
            vals = torch.stack([_t(f(t)) for t in grid])
            c = torch.cat([vals.new_zeros(1), torch.cumsum(
                0.5 * (vals[1:] + vals[:-1]) * (grid[1] - grid[0]), 0)])
            return lambda t: _interp(_t(t), grid, c)

        B = B_t if B_t is not None else cumint(beta_t)

        def scale_t(t):
            return torch.exp(-0.5 * _t(B(t)))

        var_int = cumint(lambda t: _t(xi_t(t)) / (scale_t(t) ** 2).clamp_min(1e-12))

        def sigma_t(t):
            return var_int(t).clamp_min(1e-12).sqrt()

        super().__init__(sigma_t=sigma_t, scale_t=scale_t, alpha=alpha, T=T, denoiser=denoiser)


class FlowMatching(EDMDiffusionSDE):
    r"""Flow matching as an EDM SDE (sde.py:375): ``x_t = a(t) x_0 + b(t) z``
    gives ``s = a``, ``sigma = b / a``; ``alpha = 0`` (default) is the
    straight-path ODE. The grid is clipped to [0, T] (``a(1) = 0``)."""

    def __init__(self, denoiser=None, timesteps=None, a_t: Callable = None,
                 a_prime_t: Callable = None, b_t: Callable = None, b_prime_t: Callable = None,
                 alpha=0.0, T: float = 0.99):
        def one(t):
            return torch.ones((), dtype=torch.float64)

        a = a_t or (lambda t: 1 - _t(t))
        ap = a_prime_t or (lambda t: -one(t))
        b = b_t or _t
        bp = b_prime_t or one
        super().__init__(sigma_t=lambda t: _t(b(t)) / _t(a(t)), scale_t=a,
                         sigma_prime_t=lambda t: (_t(bp(t)) * _t(a(t)) - _t(b(t)) * _t(ap(t)))
                         / _t(a(t)) ** 2,
                         scale_prime_t=ap, alpha=alpha, T=T, denoiser=denoiser)
        ts = np.asarray(timesteps if timesteps is not None else np.linspace(T, 0.0, 50),
                        np.float32)
        self.timesteps = np.clip(ts, 0.0, np.float32(T))

    def sample(self, x_init, generator=None, seed: int = 0, draws=None):
        return EulerSolver(self.timesteps).sample(self, x_init, generator=generator, seed=seed,
                                                  draws=draws)

    def velocity(self, x, t, *args, **kwargs):
        """The flow's velocity field, the backward SDE's drift (sde.py:407)."""
        return self.drift(x, _t(t))


class NoisyDataFidelity(DataFidelity):
    r"""Preconditioned data fidelity of diffusion posterior sampling
    (sde.py:413): ``grad(x_t, y) = weight P(A(x_t) - y)``, ``P = A^T``."""

    def __init__(self, weight: float = 1.0):
        super().__init__()
        self.weight = weight

    def precond(self, u, physics):
        return physics.A_adjoint(u) if hasattr(physics, "A_adjoint") else physics.A_dagger(u)

    def diff(self, x, y, physics, **kwargs):
        return physics.A(x) - y

    def grad(self, x, y, physics, sigma=None, **kwargs):
        return self.weight * self.precond(self.diff(x, y, physics, **kwargs), physics)


class DPSDataFidelity(NoisyDataFidelity):
    r"""The guidance ``grad_x weight sqrt(1/2) ||y - A(D(x, sigma))||``
    (sde.py:435), by autograd through the denoiser with respect to ``x``
    alone (:func:`~deepinv_tpu_torch.sampling.utils.frozen`).

    :param clip: ``(lo, hi)`` to clip the denoised estimate to, or None.
    """

    def __init__(self, denoiser, weight: float = 1.0, clip=None):
        super().__init__(weight=weight)
        self.denoiser = denoiser
        self.clip = tuple(sorted(clip)) if clip is not None else None

    def grad(self, x, y, physics, sigma=None, **kwargs):
        with torch.enable_grad(), frozen(self.denoiser):
            u = x.detach().requires_grad_()
            x0 = self.denoiser(u, sigma)
            if self.clip is not None:
                x0 = x0.clamp(self.clip[0], self.clip[1])
            r = physics.A(x0) - y
            (g,) = torch.autograd.grad((0.5 * r.square().sum()).sqrt(), u)
        return self.weight * g


class PosteriorDiffusion(Reconstructor):
    r"""Reverse-time SDE with data-fidelity guidance (sde.py:461): the drift
    is the SDE's plus ``g(t)^2`` times the guidance at the de-scaled state.

    :param sde: a :class:`DiffusionSDE`.
    :param data_fidelity: e.g. :class:`DPSDataFidelity`.
    :param solver: default :class:`EulerSolver` on ``timesteps``
        (default ``linspace(1, 1e-3, 100)``).
    """

    def __init__(self, sde: DiffusionSDE, data_fidelity: DPSDataFidelity, solver=None,
                 timesteps=None):
        super().__init__()
        self.sde = sde
        self.data_fidelity = data_fidelity
        if timesteps is None:
            timesteps = np.linspace(1.0, 1e-3, 100)
        self.solver = solver if solver is not None else EulerSolver(timesteps)

    def _guide(self, x, y, physics, t):
        sigma = self.sde.sigma_t(t) if hasattr(self.sde, "sigma_t") else 0.1
        scale = self.sde.scale_t(t) if hasattr(self.sde, "scale_t") else 1.0
        return self.data_fidelity.grad(x / scale, y, physics, sigma) / scale

    def forward(self, y, physics, generator=None, seed: int = 0, x_init=None, draws=None,
                **kwargs):
        """One draw for the prior sample, then one a step (sde.py:473-501).

        :param generator: ``torch.Generator`` on ``y``'s device (seeded from
            ``seed`` if None). :param draws: the draws in order
            (:class:`~deepinv_tpu_torch.core.rng.Draws`).
        """
        normal = Draws.of(generator, seed, draws)
        if x_init is None:
            shape = physics.A_adjoint(y).shape
            x_init = self.sde.prior_sample(shape, device=y.device, draws=normal)
        base_drift, base_diff = self.sde.drift, self.sde.diffusion

        def guided_drift(x, t):
            # timesteps decrease (dt < 0): +g^2 guide moves along -grad ||r||
            return base_drift(x, t) + base_diff(t) ** 2 * self._guide(x, y, physics, t)

        return self.solver.sample(BaseSDE(guided_drift, base_diff), x_init, draws=normal)

    def score(self, y, physics, x, t, *args, **kwargs):
        """``grad log p_t(x | y)`` (sde.py:503): the SDE's score minus the
        guidance at the de-scaled state."""
        t = _t(t)
        if self.data_fidelity is None:
            return self.sde.score(x, t, *args, **kwargs)
        return self.sde.score(x, t, *args, **kwargs) - self._guide(x, y, physics, t)

"""MCMC sampling iterators (port of deepinv_tpu/sampling/iterators.py).

Each iterator maps the chain state ``X = {"x": x}`` to the next one. Where
the JAX iterators take a key, the port's take ``normal``, the run's
:class:`~deepinv_tpu_torch.core.rng.Draws` source.
"""

from __future__ import annotations

import math

from torch import nn

__all__ = ["SamplingIterator", "ULAIterator", "SKRockIterator", "DiffusionIterator"]


class SamplingIterator(nn.Module):
    """Base sampling iterator (deepinv_tpu/sampling/iterators.py:19).

    :param algo_params: the step's parameters.
    :param clip: ``(lo, hi)`` to clip each new sample to, or None.
    """

    def __init__(self, algo_params: dict = None, clip=None):
        super().__init__()
        self.algo_params = dict(algo_params or {})
        self.clip = clip

    def initialize(self, x_init):
        return {"x": x_init}

    def initialize_latent_variables(self, x_init, y, physics, cur_data_fidelity, cur_prior):
        """The chain's first state (iterators.py:27); override to add latent
        variables beside ``{"x": x}``."""
        return {"x": x_init}

    def _clip(self, x):
        if self.clip is not None:
            x = x.clamp(self.clip[0], self.clip[1])
        return x

    def forward(self, X, y, physics, data_fidelity, prior, iteration, normal):
        raise NotImplementedError


class ULAIterator(SamplingIterator):
    r"""Unadjusted Langevin step (iterators.py:43):
    ``x+ = x + eta (grad log p(y|x) + alpha grad log p(x)) + sqrt(2 eta) z``.

    algo_params: ``step_size``, ``alpha`` (1), ``sigma`` (0.05, the prior's
    denoiser level).
    """

    def forward(self, X, y, physics, data_fidelity, prior, iteration, normal):
        x = X["x"]
        eta = self.algo_params["step_size"]
        alpha = self.algo_params.get("alpha", 1.0)
        sigma = self.algo_params.get("sigma", 0.05)
        noise = normal.like(x) * math.sqrt(2 * eta)
        lhood = -data_fidelity.grad(x, y, physics)
        lprior = -prior.grad(x, sigma) * alpha
        return {"x": self._clip(x + eta * (lhood + lprior) + noise)}


class SKRockIterator(SamplingIterator):
    r"""SK-ROCK step (iterators.py:62): a stabilized Runge-Kutta-Chebyshev
    Langevin step of ``inner_iter`` stages, one posterior gradient (and so one
    denoiser call) a stage.

    algo_params: ``step_size``, ``alpha`` (1), ``inner_iter`` (10), ``eta``
    (0.05, the damping), ``sigma`` (0.05).
    """

    def forward(self, X, y, physics, data_fidelity, prior, iteration, normal):
        x = X["x"]
        p = self.algo_params
        eta_damp = p.get("eta", 0.05)
        s = int(p.get("inner_iter", 10))
        step = p["step_size"]
        alpha = p.get("alpha", 1.0)
        sigma = p.get("sigma", 0.05)

        def posterior(u):
            return data_fidelity.grad(u, y, physics) + alpha * prior.grad(u, sigma)

        w0 = 1 + eta_damp / s ** 2
        th = math.acosh(w0)

        def T(k):
            return math.cosh(k * th)

        w1 = T(s) / (s * math.sinh(s * th) / math.sinh(th))
        mu1, nu1, kappa1 = w1 / w0, s * w1 / 2, s * (w1 / w0)
        noise = normal.like(x) * math.sqrt(2 * step)
        xts_2 = x
        xts = x - mu1 * step * posterior(x + nu1 * noise) + kappa1 * noise
        for js in range(2, s + 1):
            xts_1 = xts
            mu = 2 * w1 * T(js - 1) / T(js)
            nu = 2 * w0 * T(js - 1) / T(js)
            xts = -mu * step * posterior(xts) + nu * xts + (1 - nu) * xts_2
            xts_2 = xts_1
        return {"x": self._clip(xts)}


class DiffusionIterator(SamplingIterator):
    """One Monte-Carlo iteration is a whole diffusion run from fresh noise
    (iterators.py:108); ``prior`` is the diffusion sampler, which draws from
    the chain's source."""

    def forward(self, X, y, physics, data_fidelity, prior, iteration, normal):
        return {"x": self._clip(prior(y, physics, draws=normal))}

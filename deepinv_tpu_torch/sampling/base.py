"""Monte-Carlo chains (port of deepinv_tpu/sampling/base.py): burn-in,
thinning, the online mean and variance, the history of the last samples and
the convergence flags.

The JAX package runs the chain as one ``lax.scan`` with the Welford moments
in its carry; the port runs a Python loop. Inclusion is decided on the host
from the iteration number, so a step reads nothing back from the device; the
convergence flags are read once, after the chain.
"""

from __future__ import annotations

import collections

import torch
from torch import nn

from ..core.rng import Draws
from ..optim.data_fidelity import L2
from .iterators import DiffusionIterator, SamplingIterator, SKRockIterator, ULAIterator

__all__ = ["BaseSampling", "sampling_builder", "ULA", "SKRock", "DiffusionSampler"]


def _rel_change(new, old):
    """``||new - old|| / (||new|| + 1e-12)``, a device scalar."""
    return torch.linalg.vector_norm(new - old) / (torch.linalg.vector_norm(new) + 1e-12)


class BaseSampling(nn.Module):
    """Monte-Carlo sampler over a sampling iterator
    (deepinv_tpu/sampling/base.py:24).

    :param iterator: a :class:`~deepinv_tpu_torch.sampling.SamplingIterator`.
    :param data_fidelity: the negative log-likelihood (default
        :class:`~deepinv_tpu_torch.optim.L2`).
    :param prior: e.g. :class:`~deepinv_tpu_torch.optim.ScorePrior`.
    :param max_iter: the chain's length.
    :param burnin_ratio: the share of iterations left out at the start.
    :param thinning: keep every ``thinning``-th sample after the burn-in.
    :param thresh_conv: the relative change of the running mean (variance)
        below which it counts as converged.
    :param history_size: the last samples kept (``True``: all of them,
        ``False`` or 0: none).
    """

    def __init__(self, iterator: SamplingIterator, data_fidelity=None, prior=None,
                 max_iter: int = 100, burnin_ratio: float = 0.2, thinning: int = 1,
                 thresh_conv: float = 1e-3, history_size=5, verbose: bool = False):
        super().__init__()
        self.iterator = iterator
        self.data_fidelity = data_fidelity if data_fidelity is not None else L2()
        self.prior = prior
        self.max_iter = max_iter
        self.burnin_ratio = burnin_ratio
        self.thinning = thinning
        self.thresh_conv = thresh_conv
        self.history_size = history_size
        self.verbose = verbose
        self.mean_convergence = False
        self.var_convergence = False
        self.history = []

    def sample(self, y, physics, x_init=None, generator=None, seed: int = 0, draws=None):
        """Run the chain; returns the ``(mean, var)`` of the samples kept.

        :param generator: ``torch.Generator`` on ``y``'s device (seeded from
            ``seed`` if None). :param draws: the draws in the chain's order
            (:class:`~deepinv_tpu_torch.core.rng.Draws`).
        """
        normal = Draws.of(generator, seed, draws)
        if x_init is None:
            x_init = physics.A_adjoint(y)
        X = self.iterator.initialize(x_init)
        burnin = int(self.max_iter * self.burnin_ratio)
        if self.history_size is True:
            hsize = max((self.max_iter - burnin - 1) // self.thinning + 1, 1)
        else:
            hsize = max(int(self.history_size or 0), 0)
        ring = collections.deque(maxlen=hsize)
        mean, m2, count = torch.zeros_like(x_init), torch.zeros_like(x_init), 0
        dmean = dvar = None
        for it in range(self.max_iter):
            X = self.iterator(X, y, physics, self.data_fidelity, self.prior, it, normal)
            if it < burnin or (it - burnin) % self.thinning:
                continue
            x = X["x"]
            count += 1
            delta = x - mean
            mean_new = mean + delta / count
            m2_new = m2 + delta * (x - mean_new)
            if hsize:
                ring.append(x)
            dmean, dvar = _rel_change(mean_new, mean), _rel_change(m2_new, m2)
            mean, m2 = mean_new, m2_new
        var = m2 / max(count - 1, 1)
        self.history = list(ring)
        self.mean_convergence = dmean is not None and bool(dmean < self.thresh_conv)
        self.var_convergence = dvar is not None and bool(dvar < self.thresh_conv)
        return mean, var

    def get_chain(self):
        """The last ``history_size`` samples kept, oldest first (base.py:128)."""
        if self.history_size is False or self.history_size == 0:
            raise RuntimeError("Samples have not been saved: set history_size to True or an "
                               "int when constructing the sampler")
        return list(self.history)

    def mean_has_converged(self) -> bool:
        """Whether the running mean moved less than ``thresh_conv``
        (relative) at the last sample kept."""
        return self.mean_convergence

    def var_has_converged(self) -> bool:
        """Whether the running variance moved less than ``thresh_conv``
        (relative) at the last sample kept."""
        return self.var_convergence

    def forward(self, y, physics, x_init=None, generator=None, seed: int = 0, draws=None):
        return self.sample(y, physics, x_init=x_init, generator=generator, seed=seed,
                           draws=draws)[0]


def sampling_builder(iteration, data_fidelity=None, prior=None, params_algo=None, max_iter=100,
                     **kwargs) -> BaseSampling:
    """A sampler by name, ``"ULA"`` or ``"SKROCK"``, or over an iterator
    (base.py:156)."""
    if isinstance(iteration, SamplingIterator):
        it = iteration
    else:
        cls = {"ULA": ULAIterator, "SKROCK": SKRockIterator}.get(str(iteration).upper())
        if cls is None:
            raise ValueError(f"unknown sampling iteration {iteration!r}")
        it = cls(params_algo or {})
    return BaseSampling(it, data_fidelity=data_fidelity, prior=prior, max_iter=max_iter,
                        **kwargs)


def ULA(prior, data_fidelity, step_size=1e-4, sigma=0.05, alpha=1.0, max_iter=1000,
        burnin_ratio=0.2, thinning=10, clip=(-1.0, 2.0), **kwargs):
    """Unadjusted Langevin sampler (base.py:171), one denoiser call a step
    through a :class:`~deepinv_tpu_torch.optim.ScorePrior`."""
    it = ULAIterator({"step_size": step_size, "alpha": alpha, "sigma": sigma}, clip=clip)
    return BaseSampling(it, data_fidelity=data_fidelity, prior=prior, max_iter=max_iter,
                        burnin_ratio=burnin_ratio, thinning=thinning, **kwargs)


def SKRock(prior, data_fidelity, step_size=1e-4, sigma=0.05, alpha=1.0, inner_iter=10, eta=0.05,
           max_iter=1000, burnin_ratio=0.2, thinning=10, clip=(-1.0, 2.0), **kwargs):
    """SK-ROCK sampler (base.py:202), ``inner_iter`` denoiser calls a step."""
    it = SKRockIterator({"step_size": step_size, "alpha": alpha, "sigma": sigma,
                         "inner_iter": inner_iter, "eta": eta}, clip=clip)
    return BaseSampling(it, data_fidelity=data_fidelity, prior=prior, max_iter=max_iter,
                        burnin_ratio=burnin_ratio, thinning=thinning, **kwargs)


class DiffusionSampler(BaseSampling):
    """A diffusion sampler as a Monte-Carlo posterior sampler (base.py:217):
    ``max_iter`` runs of ``diffusion(y, physics)``, their Welford mean and
    variance.

    :param diffusion: e.g. :class:`~deepinv_tpu_torch.sampling.DDRM`,
        :class:`~deepinv_tpu_torch.sampling.DiffPIR`,
        :class:`~deepinv_tpu_torch.sampling.DPS` or
        :class:`~deepinv_tpu_torch.sampling.PosteriorDiffusion`.
    :param save_chain: keep every run's sample (:meth:`get_chain`).
    """

    def __init__(self, diffusion, max_iter: int = 100, clip=(-1.0, 2.0),
                 thres_conv: float = 1e-1, verbose: bool = False, save_chain: bool = False):
        super().__init__(DiffusionIterator(clip=clip), data_fidelity=None, prior=diffusion,
                         max_iter=int(max_iter), burnin_ratio=0.0, thinning=1,
                         thresh_conv=thres_conv, verbose=verbose,
                         history_size=True if save_chain else False)

"""Diffusion posterior samplers: DDRM, DiffPIR and DPS (port of
deepinv_tpu/sampling/diffusion.py).

The JAX samplers run their timestep loop as one ``lax.scan``; the port runs
a Python loop whose schedule scalars are Python floats made before it, so a
step reads nothing back from the device. Each sampler draws its normals from
a :class:`~deepinv_tpu_torch.core.rng.Draws` source in the JAX
sampler's order (``generator=`` or, in the parity tests, ``draws=``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rng import Draws
from ..models.base import Reconstructor
from ..optim.data_fidelity import L2
from .utils import frozen

__all__ = ["DDRM", "DiffPIR", "DPS"]


def _noise_sigma(physics, default):
    """The physics' Gaussian noise level, or ``default``."""
    nm = physics.noise_model
    return nm.sigma if nm is not None and hasattr(nm, "sigma") else default


class DDRM(Reconstructor):
    r"""Denoising Diffusion Restoration Models (deepinv_tpu/sampling/diffusion.py:23).

    Samples the posterior by a diffusion in the singular-value space of a
    :class:`~deepinv_tpu_torch.physics.DecomposablePhysics` (Kawar et al.
    2022), with the per-pixel case analysis as ``torch.where`` masks. One
    denoiser call for the first draw and one a step: ``len(sigmas)`` calls.

    :param denoiser: ``denoiser(x, sigma)``.
    :param sigmas: the noise levels, decreasing (default ``linspace(1, 0, 100)``).
    :param eta: the stochasticity of the steps.
    :param etab: the weight of the measurement where it dominates.
    """

    def __init__(self, denoiser, sigmas=None, eta: float = 0.85, etab: float = 1.0,
                 eps: float = 1e-6):
        super().__init__()
        self.denoiser = denoiser
        self.sigmas = np.asarray(sigmas if sigmas is not None else np.linspace(1, 0, 100),
                                 np.float32)
        self.eta = eta
        self.etab = etab
        self.eps = eps

    def forward(self, y, physics, generator=None, seed: int = 0, draws=None, **kwargs):
        """:param generator: ``torch.Generator`` on ``y``'s device (seeded
        from ``seed`` if None). :param draws: the draws in the sampler's
        order, in place of the generator's (:class:`~deepinv_tpu_torch.core.rng.Draws`)."""
        normal = Draws.of(generator, seed, draws)
        eps, eta, etab = self.eps, self.eta, self.etab
        sigma_noise = _noise_sigma(physics, 0.01)
        y_bar = physics.U_adjoint(y)
        mask = physics.mask
        if isinstance(mask, (int, float)):
            mask = torch.full(y_bar.shape, float(mask), device=y_bar.device)
        mask = mask.abs().expand(y_bar.shape)

        c = math.sqrt(1 - eta ** 2)
        case = mask > sigma_noise
        y_bar = torch.where(case, y_bar / (mask + eps), y_bar)
        nsr = torch.where(case, sigma_noise / (mask + eps), 0.0)

        sig = [float(s) for s in self.sigmas]
        s0 = sig[0]
        mean0 = torch.where(case, y_bar, 0.0)
        std0 = torch.where(case, (s0 ** 2 - nsr ** 2).clamp_min(0.0).sqrt(), s0)
        x_bar = mean0 + std0 * normal.like(y_bar) / math.sqrt(2.0)
        x = self.denoiser(physics.V(x_bar), s0)

        for s_prev, s_t in zip(sig[:-1], sig[1:]):
            xb = physics.V_adjoint(x)
            case2 = case & (nsr > s_t)
            case3 = case & (nsr <= s_t)
            mean = xb + c * s_t * (x_bar - xb) / max(s_prev, eps)
            mean = torch.where(case2, xb + c * s_t * (y_bar - xb) / (nsr + eps), mean)
            mean = torch.where(case3, (1 - etab) * xb + etab * y_bar, mean)
            std = torch.where(case3, (s_t ** 2 - (nsr * etab) ** 2).clamp_min(0.0).sqrt(),
                              eta * s_t)
            x_bar = mean + std * normal.like(xb) / math.sqrt(2.0)
            x = self.denoiser(physics.V(x_bar), max(s_t, 1e-4))
        return x


def _ddpm_schedule(beta_start=0.1 / 1000, beta_end=20 / 1000, T=1000):
    """The DDPM ``alphas_cumprod`` in float64 (diffusion.py:113)."""
    betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    return np.cumprod(1.0 - betas)


class DiffPIR(Reconstructor):
    r"""Diffusion plug-and-play image restoration (deepinv_tpu/sampling/diffusion.py:119).

    HQS on the DDPM trajectory, with the reference's schedules: quadratic
    timestep spacing, ``rho_t = lambda sigma_n^2 / sigma_t^2``, the
    ``x / (2 sqrt(a_t)) + 0.5`` renormalization of the denoiser's input, x0
    clamping and renoising to the next level. Images in [0, 1]. The last
    iteration would only denoise without changing x, so ``max_iter - 1``
    iterations run, one denoiser call each.
    """

    def __init__(self, model, data_fidelity=None, sigma: float = 0.05, max_iter: int = 100,
                 zeta: float = 0.1, lambda_: float = 7.0):
        super().__init__()
        self.model = model
        self.data_fidelity = data_fidelity if data_fidelity is not None else L2()
        self.sigma = sigma
        self.max_iter = max_iter
        self.zeta = zeta
        self.lambda_ = lambda_
        # host-side schedule tables (diffusion.py:139-146)
        self.beta_start, self.beta_end = 0.1 / 1000, 20 / 1000
        self.num_train_timesteps = 1000
        (self._sqrt_1m_acp, self._reduced, self._sqrt_acp, self._sqrt_recip_acp,
         self._sqrt_recipm1_acp, self._betas) = self.get_alpha_beta()
        self._T = self.num_train_timesteps

    def get_alpha_beta(self):
        """``(sqrt_1m_alphas_cumprod, reduced_alpha_cumprod, sqrt_alphas_cumprod,
        sqrt_recip_alphas_cumprod, sqrt_recipm1_alphas_cumprod, betas)`` as
        float32 numpy tables (diffusion.py:148)."""
        betas = np.linspace(self.beta_start, self.beta_end, self.num_train_timesteps,
                            dtype=np.float64)
        acp = np.cumprod(1.0 - betas)
        sqrt_acp = np.sqrt(acp).astype(np.float32)
        sqrt_1m_acp = np.sqrt(1 - acp).astype(np.float32)
        reduced = (sqrt_1m_acp / sqrt_acp).astype(np.float32)
        return (sqrt_1m_acp, reduced, sqrt_acp, np.sqrt(1.0 / acp).astype(np.float32),
                np.sqrt(1.0 / acp - 1.0).astype(np.float32), betas.astype(np.float32))

    def get_noise_schedule(self, sigma):
        """``(rhos, sigmas, seq)`` for measurement noise ``sigma`` (diffusion.py:164)."""
        sigmas, rhos, seq = self._schedule(sigma)
        return rhos, sigmas, seq

    @staticmethod
    def find_nearest(array, value):
        """Argmin of ``|array - value|`` (diffusion.py:173)."""
        return int(np.abs(np.asarray(array) - value).argmin())

    @staticmethod
    def compute_alpha(betas, t):
        """``alpha_bar_t`` from the betas (diffusion.py:178)."""
        return np.cumprod(1.0 - np.asarray(betas))[t]

    def get_alpha_prod(self, beta_start=0.1 / 1000, beta_end=20 / 1000,
                       num_train_timesteps=1000):
        """``(sqrt_recip_alphas_cumprod, sqrt_recipm1_alphas_cumprod)``
        (diffusion.py:184)."""
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        acp = np.cumprod(1.0 - betas)
        return (np.sqrt(1.0 / acp).astype(np.float32),
                np.sqrt(1.0 / acp - 1.0).astype(np.float32))

    def _schedule(self, sigma_n):
        """The reversed reduced-alpha noise levels, rhos by timestep and the
        quadratic subsampling of [0, T) (diffusion.py:195)."""
        T, K = self._T, self.max_iter
        sigmas = self._reduced[::-1]
        rhos = self.lambda_ * (sigma_n ** 2) / (self._reduced ** 2)
        seq = np.sqrt(np.linspace(0.0, float(T) ** 2, K)).astype(np.int32)
        seq[-1] = seq[-1] - 1
        return sigmas, rhos, seq

    def _rows(self, sigma_n):
        """Per iteration ``(curr_sigma, sqrt_acp_t, sqrt_1m_acp_t, rho_t,
        sqrt_acp_next, sqrt_1m_acp_next)`` as float32 values (diffusion.py:214-232)."""
        sigmas, rhos, seq = self._schedule(sigma_n)

        def t_of(s):
            return int(np.abs(self._reduced - sigmas[s]).argmin())

        rows = []
        for i in range(self.max_iter - 1):
            t_i, t_im1 = t_of(seq[i]), t_of(seq[i + 1])
            rows.append([sigmas[seq[i]], self._sqrt_acp[t_i], self._sqrt_1m_acp[t_i],
                         rhos[t_i], self._sqrt_acp[t_im1], self._sqrt_1m_acp[t_im1]])
        rows = np.asarray(rows, np.float32).reshape(-1, 6)
        return [[float(v) for v in r] for r in rows], float(sigmas[seq[0]])

    def forward(self, y, physics, generator=None, seed: int = 0, x_init=None, draws=None,
                **kwargs):
        """:param generator: ``torch.Generator`` on ``y``'s device (seeded
        from ``seed`` if None). :param draws: the draws in the sampler's
        order (:class:`~deepinv_tpu_torch.core.rng.Draws`)."""
        normal = Draws.of(generator, seed, draws)
        sigma_n = _noise_sigma(physics, self.sigma)
        # one read of the noise level, before the loop
        sigma_n = float(torch.as_tensor(sigma_n).reshape(-1)[0])
        rows, sigma0 = self._rows(sigma_n)

        x = 2 * (physics.A_adjoint(y) if x_init is None else x_init) - 1
        # the first (largest) level's noise, VP-scaled (diffusion.py:236-244)
        init_std = math.sqrt(max(sigma0 ** 2 - 4.0 * self.sigma ** 2, 0.0))
        x = (x + init_std * normal.like(x)) * float(self._sqrt_acp[-1])
        zeta = self.zeta
        for curr_sigma, sa_t, s1m_t, rho_t, sa_p, s1m_p in rows:
            out = self.model(x / (2 * sa_t) + 0.5, curr_sigma / 2)
            x0 = (2 * out - 1).clamp(-1.0, 1.0)
            x0 = 2 * self.data_fidelity.prox(x0 / 2 + 0.5, y, physics,
                                             gamma=1.0 / (2 * rho_t)) - 1
            eps = (x - sa_t * x0) / max(s1m_t, 1e-12)
            x = sa_p * x0 + s1m_p * (math.sqrt(1 - zeta) * eps
                                     + math.sqrt(zeta) * normal.like(x))
        return x / 2 + 0.5


class DPS(Reconstructor):
    r"""Diffusion posterior sampling (deepinv_tpu/sampling/diffusion.py:278).

    DDPM reverse diffusion with the likelihood guidance
    ``grad_x ||y - A(D(x_t))||``, by autograd through the denoiser with
    respect to ``x_t`` alone (:meth:`guidance`): one denoiser call and its
    backward a step.
    """

    def __init__(self, model, data_fidelity=None, max_iter: int = 100, eta: float = 1.0,
                 guidance_scale: float = 1.0):
        super().__init__()
        self.model = model
        self.data_fidelity = data_fidelity if data_fidelity is not None else L2()
        self.max_iter = max_iter
        self.eta = eta
        self.guidance_scale = guidance_scale
        acp = _ddpm_schedule()
        self._acp = acp.astype(np.float32)
        steps = np.linspace(len(acp) - 1, 1, max_iter).astype(np.int64)
        at = acp[steps]
        at_next = np.concatenate([acp[steps[1:]], [1.0]])
        # (at, at_next) a step, float32 values (diffusion.py:297-300)
        self._sched = [(float(a), float(b)) for a, b in
                       np.stack([at, at_next], 1).astype(np.float32)]

    def guidance(self, x, y, physics, at: float):
        """One step's guidance at ``x`` and ``alpha_bar = at``:
        ``(grad_x ||A(x0) - y||, x0, ||A(x0) - y||)`` with ``x0`` the
        denoised estimate in [-1, 1] (the loss of diffusion.py:315-330); the
        denoiser's weights ask for no gradient (:func:`frozen`)."""
        sigma = math.sqrt(max(1 - at, 1e-8)) / math.sqrt(at)
        with torch.enable_grad(), frozen(self.model):
            xt = x.detach().requires_grad_()
            x0 = 2 * self.model((xt / math.sqrt(at) + 1) / 2, sigma / 2) - 1
            r = physics.A((x0 + 1) / 2) - y
            norm = r.square().sum().sqrt()
            (g,) = torch.autograd.grad(norm, xt)
        return g, x0.detach(), norm.detach()

    def forward(self, y, physics, generator=None, seed: int = 0, x_init=None, draws=None,
                **kwargs):
        """:param generator: ``torch.Generator`` on ``y``'s device (seeded
        from ``seed`` if None). :param draws: the draws in the sampler's
        order (:class:`~deepinv_tpu_torch.core.rng.Draws`)."""
        normal = Draws.of(generator, seed, draws)
        if x_init is None:
            shape = physics.A_adjoint(y).shape
            x = normal.normal(shape, torch.float32 if y.is_complex() else y.dtype, y.device)
        else:
            x = 2 * x_init - 1
        x0 = None
        for at, at_next in self._sched:
            g, x0, _ = self.guidance(x, y, physics, at)
            eps = (x - math.sqrt(at) * x0) / math.sqrt(max(1 - at, 1e-8))
            c1 = self.eta * math.sqrt(max((1 - at / at_next) * (1 - at_next)
                                          / max(1 - at, 1e-8), 0.0))
            c2 = math.sqrt(max(1 - at_next - c1 ** 2, 0.0))
            x = (math.sqrt(at_next) * x0 + c2 * eps + c1 * normal.like(x)
                 - self.guidance_scale * g)
        return (x0 + 1) / 2

    def score(self, y, physics, x, t, *args, **kwargs):
        """The conditional score ``grad log p_t(x | y)`` (diffusion.py:347):
        the denoiser's Tweedie score minus the guidance gradient."""
        at = float(self._acp[int(t)])
        g, x0, _ = self.guidance(x, y, physics, at)
        uncond = (math.sqrt(at) * x0 - x) / max(1 - at, 1e-8)
        return uncond - self.guidance_scale * g

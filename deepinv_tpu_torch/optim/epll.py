"""Expected patch log-likelihood and Gaussian mixture models (port of
deepinv_tpu/optim/epll.py): full-batch EM fitting of a full-covariance GMM
over patches, and EPLL denoising by half-quadratic splitting (Zoran and
Weiss): each patch Wiener-filtered by its most likely component, the
patches averaged back, the closed-form data step."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device

__all__ = ["GaussianMixtureModel", "EPLL", "patch_extractor"]


def patch_extractor(x, patch_size: int, stride: int = 1):
    """Every ``patch_size``² patch of ``(B, C, H, W)`` at ``stride``, as ``(B,
    N, C p p)`` row-major over the patch grid, and the grid ``(nh, nw)``
    (deepinv_tpu/optim/epll.py:24)."""
    B, C, H, W = x.shape
    p = patch_size
    nh, nw = (H - p) // stride + 1, (W - p) // stride + 1
    return F.unfold(x, p, stride=stride).transpose(1, 2), (nh, nw)


class GaussianMixtureModel(nn.Module):
    """Full-covariance Gaussian mixture with EM fitting (epll.py:42). The
    means start as normal draws times 0.1 (from ``generator``, seeded from
    ``seed`` where None, or handed in by ``draws=``), the covariances at the
    identity, the weights uniform.

    :param device: the CUDA device by default.
    """

    def __init__(self, n_components: int, dimension: int, generator=None, seed: int = 0,
                 draws=None, device=None):
        device = resolve_device(device)
        super().__init__()
        mu = Draws.of(generator, seed, draws).normal((n_components, dimension)) * 0.1
        self.register_buffer("mu", mu.to(device))
        self.register_buffer("cov", torch.eye(dimension, device=device)[None].repeat(
            n_components, 1, 1))
        self.register_buffer("weights", torch.full((n_components,), 1.0 / n_components,
                                                   device=device))

    @property
    def n_components(self) -> int:
        return self.mu.shape[0]

    def _chol(self, cov=None):
        cov = self.cov if cov is None else cov
        return torch.linalg.cholesky(cov + 1e-5 * torch.eye(cov.shape[-1], device=cov.device,
                                                             dtype=cov.dtype))

    def log_prob_components(self, x, mu=None, cov=None):
        """``log N(x | mu_k, cov_k)`` of ``(N, d)`` points: ``(K, N)``
        (epll.py:60)."""
        mu = self.mu if mu is None else mu
        d = x.shape[-1]
        chol = self._chol(cov)
        diff = x[None] - mu[:, None]                                   # (K, N, d)
        sol = torch.linalg.solve_triangular(chol, diff.transpose(1, 2), upper=False)
        maha = (sol ** 2).sum(1)
        logdet = 2 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * (maha + logdet[:, None] + d * math.log(2 * math.pi))

    def log_prob(self, x):
        """The mixture's log-density of ``(N, d)`` points (epll.py:74)."""
        lp = self.log_prob_components(x) + torch.log(self.weights)[:, None]
        return torch.logsumexp(lp, dim=0)

    def classify(self, x):
        """Each point's most likely component (epll.py:78)."""
        lp = self.log_prob_components(x) + torch.log(self.weights)[:, None]
        return lp.argmax(0)

    @torch.no_grad()
    def fit(self, x, max_iters: int = 50, tol: float = 1e-4, verbose: bool = False,
            generator=None, draws=None):
        """Full-batch EM on ``(N, d)`` points (epll.py:82), from means at
        ``n_components`` distinct points drawn from ``generator`` (seeded 1
        where None), or handed in by ``draws=`` (their indices); stops when
        the mean log-likelihood moves by less than ``tol``. Updates the model
        in place and returns it."""
        x = torch.as_tensor(x, dtype=self.mu.dtype, device=self.mu.device)
        K, n = self.n_components, x.shape[0]
        dr = Draws.of(generator, 1, draws, device=x.device)
        idx = dr._next((K,), torch.long) if dr.given else dr.permutation(n)[:K]
        mu, cov, w = x[idx.to(x.device)], self.cov, self.weights
        eye = torch.eye(x.shape[-1], device=x.device, dtype=x.dtype)
        prev = -math.inf
        for it in range(max_iters):
            lp = self.log_prob_components(x, mu, cov) + torch.log(w)[:, None]
            lse = torch.logsumexp(lp, dim=0, keepdim=True)
            r = torch.exp(lp - lse)                                    # (K, N)
            nk = r.sum(1) + 1e-8
            mu = (r @ x) / nk[:, None]
            diff = (x[None] - mu[:, None]).double()
            # the weighted Gram matrix in float64: in float32 its null directions
            # (patches of piecewise-constant images span few) fall below the
            # 1e-5 jitter on the card, and the Cholesky of the next step fails
            cov = (torch.einsum("kn,knd,kne->kde", r.double(), diff, diff)
                   / nk[:, None, None].double()).to(x.dtype) + 1e-5 * eye
            w = nk / nk.sum()
            ll = float(lse.mean())
            if verbose:
                print(f"EM iter {it}: loglik {ll:.4f}")
            if abs(ll - prev) < tol:
                break
            prev = ll
        self.mu, self.cov, self.weights = mu, cov, w
        return self


class EPLL(nn.Module):
    """EPLL half-quadratic-splitting patch denoiser (epll.py:117).

    :param gmm: a fitted :class:`GaussianMixtureModel` over flattened patches;
        a 20-component one from ``generator`` where None.
    :param patch_size: the patches' side.
    :param channels: image channels.
    :param betas: the splitting's penalties, in units of ``1 / sigma^2``.
    :param device: the CUDA device by default.
    """

    def __init__(self, gmm: GaussianMixtureModel = None, patch_size: int = 6, channels: int = 1,
                 betas=None, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        self.patch_size = patch_size
        self.channels = channels
        d = channels * patch_size ** 2
        self.gmm = gmm if gmm is not None else GaussianMixtureModel(20, d, generator=generator,
                                                                     device=device)
        self.betas = tuple(betas) if betas is not None else (1.0, 4.0, 8.0, 16.0, 32.0)

    def negative_log_likelihood(self, x):
        """``-sum log p(patch)`` over each image's patches (epll.py:132)."""
        patches, _ = patch_extractor(x, self.patch_size)
        B, N, d = patches.shape
        return -self.gmm.log_prob(patches.reshape(B * N, d)).reshape(B, N).sum(1)

    def _wiener(self, patches, noise_var):
        """Each ``(N, d)`` patch Wiener-filtered by its most likely component
        (epll.py:138)."""
        k = self.gmm.classify(patches)
        mu, cov = self.gmm.mu[k], self.gmm.cov[k]
        A = cov + noise_var * torch.eye(patches.shape[-1], device=patches.device)[None]
        sol = torch.linalg.solve(A, (patches - mu)[..., None])[..., 0]
        return mu + torch.einsum("nde,ne->nd", cov, sol)

    def denoise(self, y, sigma: float):
        """EPLL-HQS denoising of ``y`` at noise level ``sigma`` (epll.py:149)."""
        x = y
        for beta_rel in self.betas:
            beta = beta_rel / sigma ** 2
            patches, grid = patch_extractor(x, self.patch_size)
            B, N, d = patches.shape
            cleaned = self._wiener(patches.reshape(B * N, d), 1.0 / beta).reshape(B, N, d)
            x = self._paste_average(y, cleaned, grid, beta, sigma)
        return x

    def _paste_average(self, y, cleaned, grid, beta, sigma):
        """The patches summed back into place and divided by their count, then
        the closed-form data step ``(y / sigma^2 + beta avg) / (1 / sigma^2 +
        beta)`` (epll.py:162)."""
        p = self.patch_size
        H, W = y.shape[-2:]
        acc = F.fold(cleaned.transpose(1, 2), (H, W), p)
        ones = torch.ones((1, p * p, cleaned.shape[1]), dtype=y.dtype, device=y.device)
        cnt = F.fold(ones, (H, W), p)
        avg = acc / cnt.clamp_min(1.0)
        return (y / sigma ** 2 + beta * avg) / (1.0 / sigma ** 2 + beta)

    def forward(self, x, sigma=0.05, **kwargs):
        return self.denoise(x, float(sigma) if not isinstance(sigma, torch.Tensor) else sigma)

"""Classic (training-free) denoisers (port of deepinv_tpu/models/classic.py):
the finite-difference operators of the TV family and :class:`TVDenoiser`.
``TVL1Denoiser``, ``TGVDenoiser``, the wavelet, median, bilateral and
Anscombe denoisers wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import torch

from ..ops.kernels.tv import fwd_diff_nd as _fwd_diff_nd
from ..ops.kernels.tv import fwd_diff_nd_adjoint
from .base import Denoiser

__all__ = ["TVDenoiser"]


class _TVOpsMixin:
    """Finite-difference operators shared by the TV family
    (deepinv_tpu/models/classic.py:39)."""

    @staticmethod
    def nabla(x):
        """Forward-difference gradient ``(B, C, H, W[, D]) -> (..., n_spatial)``,
        zero at the trailing edge (classic.py:43)."""
        if x.dim() not in (4, 5):
            raise ValueError(f"Input tensor must be 4D or 5D, got {x.dim()}D")
        return _fwd_diff_nd(x, 2)

    @staticmethod
    def nabla_adjoint(u):
        """Adjoint of :meth:`nabla` (classic.py:51)."""
        if u.dim() not in (5, 6):
            raise ValueError(f"Input tensor must be 5D or 6D, got {u.dim()}D")
        return fwd_diff_nd_adjoint(u, 2)

    def prox_tau_fx(self, x, y):
        """Prox of ``1/2 ||x - y||^2`` at stepsize ``tau`` (classic.py:61)."""
        return (x + self.tau * y) / (1 + self.tau)

    def prox_sigma_g_conj(self, u, lambda2):
        """Projection of the dual variable onto the ``lambda2`` ball
        (classic.py:66)."""
        n = torch.sqrt((u * u).sum(-1, keepdim=True))
        return u / torch.clamp(n / lambda2, min=1.0)


class TVDenoiser(_TVOpsMixin, Denoiser):
    """Isotropic TV denoiser (deepinv_tpu/models/classic.py:73): the prox of
    ``ths * TV`` by Chambolle's dual algorithm, through
    :meth:`~deepinv_tpu_torch.optim.TVPrior.prox` (the K7 kernel on the GPU).

    :param n_it_max: Chambolle iterations.
    :param use_pallas: ``False`` runs the plain PyTorch version on any
        device (the JAX package's switch, kept under its name).
    :param tau: step of :meth:`prox_tau_fx`.
    """

    def __init__(self, n_it_max: int = 200, use_pallas: bool | None = None, tau: float = 0.01):
        from ..optim.prior import TVPrior

        super().__init__()
        self.tau = tau
        self.prior = TVPrior(n_it_max=n_it_max, use_pallas=use_pallas)

    def forward(self, x, ths=0.1, **kwargs):
        return self.prior.prox(x, gamma=ths)

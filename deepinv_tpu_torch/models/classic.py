"""Classic (training-free) denoisers (port of deepinv_tpu/models/classic.py):
the finite-difference operators of the TV family, the TV (on K7), TV-L1 and
TGV denoisers, wavelet and wavelet-dictionary thresholding, the median and
bilateral filters, the Anscombe wrapper and the generalized Anscombe pair.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.linalg import linear_transpose
from ..ops.kernels.tv import div_op as _div_op
from ..ops.kernels.tv import fwd_diff_nd as _fwd_diff_nd
from ..ops.kernels.tv import fwd_diff_nd_adjoint
from ..ops.kernels.tv import grad_op as _grad_op
from .base import Denoiser

__all__ = ["TVDenoiser", "TVL1Denoiser", "TGVDenoiser", "WaveletDenoiser", "WaveletDictDenoiser",
           "MedianFilter", "BilateralFilter", "AnscombeDenoiser", "generalized_anscombe_transform",
           "inverse_generalized_anscombe_transform"]


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


def _proj_ball(p, alpha):
    """Each vector of the last axis projected onto the ball of radius ``alpha``."""
    n = torch.sqrt((p * p).sum(-1, keepdim=True))
    return p / torch.clamp(n / alpha, min=1.0)


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


class TGVDenoiser(_TVOpsMixin, Denoiser):
    """Second-order total generalized variation denoiser (classic.py:100):
    ``n_it_max`` Chambolle-Pock steps at ``tau = 0.1``, ``sigma = 1 / (72
    tau)``, weights ``alpha1`` and ``alpha2`` times ``ths``, as the JAX
    package runs them."""

    def __init__(self, n_it_max: int = 200, alpha1: float = 1.0, alpha2: float = 2.0,
                 tau: float = 0.1):
        super().__init__()
        self.n_it_max = n_it_max
        self.alpha1 = alpha1
        self.alpha2 = alpha2
        self.tau = tau

    @staticmethod
    def epsilon(I):
        """The Jacobian of a vector field ``(..., n_spatial) -> (...,
        n_spatial^2)`` by backward differences with a zero leading edge,
        ``d(comp_i) / d(axis_j)`` component-major (classic.py:113)."""
        if I.dim() not in (5, 6):
            raise ValueError(f"Input tensor must be 5D or 6D, got {I.dim()}D")
        n_sp = I.dim() - 3
        comps = []
        for i in range(n_sp):
            v = I[..., i]
            for d in range(2, 2 + n_sp):
                comps.append(torch.diff(v, dim=d, prepend=v.narrow(d, 0, 1)))
        return torch.stack(comps, dim=-1)

    @staticmethod
    def epsilon_adjoint(G):
        """The adjoint of :meth:`epsilon` (classic.py:129)."""
        if G.dim() not in (5, 6):
            raise ValueError(f"Input tensor must be 5D or 6D, got {G.dim()}D")
        n_sp = math.isqrt(G.shape[-1])
        return linear_transpose(TGVDenoiser.epsilon, G, tuple(G.shape[:-1]) + (n_sp,))

    def prox_tau_fr(self, r, lambda1):
        """The prox of the TGV middle term (classic.py:142)."""
        left = torch.sqrt((r ** 2).sum(-1)) / (self.tau * lambda1)
        return r - r / torch.clamp(left, min=1.0)[..., None]

    @staticmethod
    def _grad2(v):
        """The forward-difference gradient of a 2-D vector field
        ``(..., H, W, 2) -> (..., H, W, 4)``: ``[d_H v0, d_H v1, d_W v0, d_W
        v1]`` (classic.py:152)."""
        g = [_grad_op(v[..., i]) for i in range(2)]
        return torch.stack([g[0][..., 0], g[1][..., 0], g[0][..., 1], g[1][..., 1]], dim=-1)

    @staticmethod
    def _grad2_adjoint(q):
        a = q.dim() - 3
        return torch.stack([fwd_diff_nd_adjoint(torch.stack([q[..., i], q[..., 2 + i]], -1), a)
                            for i in range(2)], dim=-1)

    def forward(self, x, ths=0.1, **kwargs):
        tau = 0.1
        sigma = 1.0 / (tau * 72.0)
        u, u_bar = x, x
        w = x.new_zeros(x.shape + (2,))
        w_bar = w
        p = x.new_zeros(x.shape + (2,))
        q = x.new_zeros(x.shape + (4,))
        for _ in range(self.n_it_max):
            p = _proj_ball(p + sigma * (_grad_op(u_bar) - w_bar), self.alpha1 * ths)
            q = _proj_ball(q + sigma * self._grad2(w_bar), self.alpha2 * ths)
            u_new = (u - tau * (-_div_op(p)) + tau * x / 1.0) / (1 + tau)
            w_new = w - tau * (self._grad2_adjoint(q) - p)
            u_bar, w_bar = 2 * u_new - u, 2 * w_new - w
            u, w = u_new, w_new
        return u


class WaveletDenoiser(Denoiser):
    """Orthonormal wavelet thresholding (classic.py:194), on
    :class:`~deepinv_tpu_torch.ops.wavelets.WaveletTransform`: the detail
    bands soft-, hard- or top-k-thresholded, the approximation kept.

    :param wv: the wavelet's name.
    :param level: decomposition levels.
    :param non_linearity: ``"soft"``, ``"hard"`` or ``"topk"``.
    :param wvdim: 2 or 3 spatial dimensions.
    """

    def __init__(self, wv: str = "db4", level: int = 3, non_linearity: str = "soft",
                 wvdim: int = 2):
        from ..ops.wavelets import WaveletTransform

        super().__init__()
        self.wt = WaveletTransform(wavelet=wv, level=level, ndim=wvdim)
        self.non_linearity = non_linearity

    @staticmethod
    def _expand_ths_as(ths, x):
        """A scalar or ``(B,)`` threshold broadcast over ``x`` (classic.py:219)."""
        t = torch.as_tensor(ths, dtype=x.dtype, device=x.device)
        return t.reshape((-1,) + (1,) * (x.dim() - 1)) if t.dim() > 0 else t

    def prox_l1(self, x, ths=0.1):
        """Soft thresholding of a coefficient array (classic.py:227)."""
        t = self._expand_ths_as(ths, x).abs()
        return torch.clamp(x - t, min=0.0) + torch.clamp(x + t, max=0.0)

    def prox_l0(self, x, ths=0.1):
        """Hard thresholding of a coefficient array (classic.py:233)."""
        t = self._expand_ths_as(ths, x)
        return torch.where(x.abs() < t, torch.zeros_like(x), x)

    @staticmethod
    def hard_threshold_topk(c, ths):
        """Each sample's ``k`` largest coefficients of a band kept
        (classic.py:240): ``ths`` below 1 a fraction of the band, else a
        count."""
        B = c.shape[0]
        flat = c.reshape(B, -1).abs()
        n = flat.shape[1]
        frac = float(torch.as_tensor(ths).reshape(-1)[0])
        k = min(int(frac) if frac >= 1 else max(1, int(frac * n)), n)
        kth = torch.sort(flat, dim=1, descending=True).values[:, k - 1]
        kth = kth.reshape((B,) + (1,) * (c.dim() - 1))
        return torch.where(c.abs() >= kth, c, torch.zeros_like(c))

    def threshold_func(self, x, ths):
        """The thresholding ``non_linearity`` names (classic.py:254)."""
        if self.non_linearity == "soft":
            return self.prox_l1(x, ths)
        if self.non_linearity == "hard":
            return self.prox_l0(x, ths)
        if self.non_linearity == "topk":
            return self.hard_threshold_topk(x, ths)
        raise ValueError(self.non_linearity)

    def thresold_func(self, x, ths):
        """The upstream spelling of :meth:`threshold_func` (classic.py:265)."""
        return self.threshold_func(x, ths)

    def reshape_ths(self, ths, level: int):
        """One threshold a detail band of ``level`` (classic.py:268): a scalar
        repeats over the 3 (2D) or 7 (3D) bands; an ``(n_levels, bands)``
        array gives its row ``level - 1``; a ``(bands,)`` one each band's."""
        numel = 3 if self.wt.ndim == 2 else 7
        if isinstance(ths, (int, float)):
            return [ths] * numel
        t = torch.as_tensor(ths)
        if t.dim() == 0:
            return [ths] * numel
        if t.dim() >= 2 and t.shape[-2] >= level:
            row = t[..., level - 1, :]
            return [row[..., c] for c in range(numel)]
        if t.shape[-1] == numel:
            return [t[..., c] for c in range(numel)]
        return [t] * numel

    def threshold_2D(self, coeffs, ths):
        """Every detail band thresholded (classic.py:285)."""
        out = [coeffs["coeffs"][0]]
        for level, details in enumerate(coeffs["coeffs"][1:], start=1):
            cur = self.reshape_ths(ths, level)
            out.append(tuple(self.threshold_func(c, cur[i]) for i, c in enumerate(details)))
        return {**coeffs, "coeffs": out}

    def thresold_2D(self, coeffs, ths):
        return self.threshold_2D(coeffs, ths)

    def threshold_3D(self, coeffs, ths):
        """The 3D bands, as the 2D ones (classic.py:297)."""
        return self.threshold_2D(coeffs, ths)

    def threshold_ND(self, coeffs, ths):
        """Dispatch on the transform's dimension (classic.py:301)."""
        if self.wt.ndim in (2, 3):
            return self.threshold_2D(coeffs, ths)
        raise ValueError(f"unsupported wavelet dimension {self.wt.ndim}")

    def dwt(self, x):
        """Wavelet decomposition (classic.py:311)."""
        return self.wt.dwt2(x)

    def iwt(self, coeffs):
        """Wavelet recomposition (classic.py:315)."""
        return self.wt.idwt2(coeffs)

    def flatten_coeffs(self, dec):
        """Every coefficient in one flat vector (classic.py:319)."""
        parts = [dec["coeffs"][0].reshape(-1)]
        parts += [c.reshape(-1) for d in dec["coeffs"][1:] for c in d]
        return torch.cat(parts)

    def pad_input(self, x):
        """Zero-pad H and W to even sizes (classic.py:326); ``(padded,
        padding)``."""
        pb, pr = x.shape[-2] % 2, x.shape[-1] % 2
        if pb or pr:
            x = F.pad(x, (0, pr, 0, pb))
        return x, (pb, pr)

    def crop_output(self, x, padding):
        """Undo :meth:`pad_input` (classic.py:335)."""
        pb, pr = padding
        return x[..., : x.shape[-2] - pb, : x.shape[-1] - pr]

    @staticmethod
    def psi(x, wavelet: str = "db2", level: int = 2, dimension: int = 2, mode: str = "zero"):
        """The coefficient arrays of ``x``, approximation first (classic.py:341)."""
        from ..ops.wavelets import WaveletTransform

        dec = WaveletTransform(wavelet=wavelet, level=level, ndim=dimension).dwt2(x)
        return [dec["coeffs"][0]] + [c for d in dec["coeffs"][1:] for c in d]

    def forward(self, x, sigma=0.1, **kwargs):
        ths = sigma if self.non_linearity == "topk" else torch.as_tensor(sigma)
        x_pad, padding = self.pad_input(x)
        t = self.threshold_ND(self.dwt(x_pad), ths)
        return self.crop_output(self.iwt(t), padding)


class WaveletDictDenoiser(Denoiser):
    """The mean of one :class:`WaveletDenoiser` a wavelet (classic.py:362)."""

    psi = staticmethod(WaveletDenoiser.psi)

    def __init__(self, list_wv=("db2", "db4", "db8"), level: int = 3, max_iter: int = 10,
                 wvdim: int = 2):
        super().__init__()
        self.denoisers = torch.nn.ModuleList(
            [WaveletDenoiser(wv=w, level=level, wvdim=wvdim) for w in list_wv])

    def forward(self, x, sigma=0.1, **kwargs):
        return sum(d(x, sigma) for d in self.denoisers) / len(self.denoisers)


class MedianFilter(Denoiser):
    """The median of each ``kernel_size``² window, reflect-padded
    (classic.py:378)."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size

    def forward(self, x, sigma=None, **kwargs):
        k, p = self.kernel_size, self.kernel_size // 2
        xp = F.pad(x, (p, p, p, p), mode="reflect")
        H, W = x.shape[-2:]
        stack = torch.stack([xp[..., i:i + H, j:j + W] for i in range(k) for j in range(k)])
        return stack.median(dim=0).values


class BilateralFilter(Denoiser):
    """The bilateral filter over a ``kernel_size``² window (classic.py:396):
    Gaussian weights in space (``sigma_space``) and in value (``sigma`` if
    given, else ``sigma_color``), reflect-padded."""

    def __init__(self, kernel_size: int = 5, sigma_space: float = 2.0, sigma_color: float = 0.1):
        super().__init__()
        self.kernel_size = kernel_size
        self.sigma_space = sigma_space
        self.sigma_color = sigma_color

    def forward(self, x, sigma=None, **kwargs):
        k, p = self.kernel_size, self.kernel_size // 2
        sc = self.sigma_color if sigma is None else sigma
        xp = F.pad(x, (p, p, p, p), mode="reflect")
        H, W = x.shape[-2:]
        num = torch.zeros_like(x)
        den = torch.zeros_like(x)
        for i in range(k):
            for j in range(k):
                shifted = xp[..., i:i + H, j:j + W]
                w_s = math.exp(-((i - p) ** 2 + (j - p) ** 2) / (2 * self.sigma_space ** 2))
                w = w_s * torch.exp(-((shifted - x) ** 2) / (2 * sc ** 2))
                num = num + w * shifted
                den = den + w
        return num / den


class AnscombeDenoiser(Denoiser):
    """A Gaussian denoiser inside the Anscombe transform (classic.py:423):
    ``2 sqrt(x / gain + 3/8)``, the denoiser at level ``sigma`` (1 if None),
    then the closed-form unbiased inverse, times ``gain``."""

    def __init__(self, denoiser, gain: float = 1.0):
        super().__init__()
        self.denoiser = denoiser
        self.gain = gain

    def forward(self, x, sigma=None, **kwargs):
        g = self.gain
        t = 2.0 * torch.sqrt(torch.clamp(x / g + 3.0 / 8.0, min=0.0))
        den = self.denoiser(t, 1.0 if sigma is None else sigma)
        d = den.clamp_min(1e-8)
        s32 = math.sqrt(3.0 / 2.0)
        inv = den ** 2 / 4.0 + s32 / (4.0 * d) - 11.0 / (8.0 * d ** 2) + 5.0 * s32 / (
            8.0 * d ** 3) - 1.0 / 8.0
        return inv * g


class TVL1Denoiser(_TVOpsMixin, Denoiser):
    """TV-L1 denoiser (classic.py:447): ``n_it_max`` primal-dual steps on
    ``||x - y||_1 + ths TV(x)`` at ``tau = sigma = 1/4``, the TV dual
    projected onto the ``ths`` ball, the l1 dual clamped to ``[-1, 1]``."""

    def __init__(self, n_it_max: int = 200, tau: float = 0.25):
        super().__init__()
        self.n_it_max = n_it_max
        self.tau = tau

    def prox_sigma_g_conj(self, u, lambda2):
        """The anisotropic dual clamp (classic.py:455)."""
        return torch.clamp(u, -lambda2, lambda2)

    def forward(self, y, ths=0.1, **kwargs):
        tau = sigma = 0.25
        x, x_bar = y, y
        p = y.new_zeros(y.shape + (2,))
        q = torch.zeros_like(y)
        for _ in range(self.n_it_max):
            p = _proj_ball(p + sigma * _grad_op(x_bar), ths)
            q = torch.clamp(q + sigma * (x_bar - y), -1.0, 1.0)
            x_new = x - tau * (-_div_op(p) + q)
            x_bar, x = 2 * x_new - x, x_new
        return x


def generalized_anscombe_transform(y, gain: float = 1.0, sigma: float = 0.0, mu: float = 0.0):
    r"""The generalized Anscombe transform of ``gain * Poisson + N(mu,
    sigma^2)`` data (classic.py:483): ``(2 / gain) sqrt(max(gain y + 3/8
    gain^2 + sigma^2 - gain mu, 0))``."""
    return (2.0 / gain) * torch.sqrt(
        torch.clamp(gain * y + 0.375 * gain ** 2 + sigma ** 2 - gain * mu, min=0.0))


def inverse_generalized_anscombe_transform(z, gain: float = 1.0, sigma: float = 0.0,
                                           mu: float = 0.0):
    r"""Its closed-form unbiased inverse (Makitalo and Foi; classic.py:492)."""
    z = z.clamp_min(1e-8)
    s15 = math.sqrt(1.5)
    ez = (0.25 * z ** 2 + 0.25 * s15 / z - 11.0 / 8.0 / z ** 2 + 5.0 / 8.0 * s15 / z ** 3
          - 0.125 - sigma ** 2 / gain ** 2)
    return gain * ez + mu

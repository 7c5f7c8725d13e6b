"""Non-uniform FFT with Kaiser-Bessel gridding (port of deepinv_tpu/ops/nufft.py).

Type 2 (:func:`nufft2`, nufft.py:70) maps an image to samples at k-space
points ``omega`` (2, M), in radians in [-pi, pi); type 1
(:func:`nufft2_adjoint`, :109) is its exact adjoint. The Toeplitz spectrum
(:func:`nufft2_toeplitz_spec`, :133) turns the normal operator ``A^H A`` into
two FFTs (:func:`nufft2_normal`, :160).

The interpolation plan — for every sample, the J x J oversampled-grid cells it
touches and their kernel weights — is built once in float64 numpy
(:class:`NufftPlan`, as ``radon_slice._adjoint_plan`` :119 does) and kept as
buffers. The JAX package computes the type-2 weights in float32 inside the
trace, so the two differ in the last bits of the weights.

The JAX package gets type 1 from ``jax.linear_transpose``. Here it is written
out: spread each sample's taps onto the oversampled grid (``index_add_``; on a
GPU its atomic adds sum in an order that varies from run to run), inverse
FFT, crop, deapodize.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .radon_fourier import _next_smooth

__all__ = ["nufft2", "nufft2_adjoint", "kb_kernel", "nufft2_toeplitz_spec", "nufft2_normal",
           "NufftPlan"]


def kb_kernel(r, J: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel interpolation kernel on ``|r| <= J/2`` (nufft.py:33),
    in float64 numpy."""
    r = np.asarray(r, np.float64)
    arg = np.clip(1 - (2 * r / J) ** 2, 0.0, None)
    return np.where(np.abs(r) <= J / 2, np.i0(beta * np.sqrt(arg)) / np.i0(beta), 0.0)


def _kb_params(J: int, osf: float) -> float:
    """Kernel shape parameter beta (nufft.py:41)."""
    return math.pi * math.sqrt((J / osf * (osf - 0.5)) ** 2 - 0.8)


def _scaling_image(N: int, G: int, J: int, beta: float) -> np.ndarray:
    """Deapodization: reciprocal of the kernel's Fourier transform, centred
    at the NUFFT phase origin (nufft.py:46), float32."""
    origin = G // 2 - (G - N) // 2
    x = (np.arange(N) - origin) / G
    arg = np.asarray((math.pi * J * x) ** 2 - beta ** 2, np.complex128)
    val = np.real(np.sinh(np.sqrt(-arg + 0j)) / np.sqrt(-arg + 0j))
    val[np.abs(val) < 1e-12] = 1e-12
    return (1.0 / val).astype(np.float32)


def _grid_setup(im_size, J: int, osf: float):
    """Oversampled grid, beta and the (N1, N2) deapodization (nufft.py:61)."""
    N1, N2 = im_size
    G1, G2 = int(N1 * osf), int(N2 * osf)
    beta = _kb_params(J, osf)
    scale = np.outer(_scaling_image(N1, G1, J, beta), _scaling_image(N2, G2, J, beta))
    return (G1, G2), beta, scale


def _interp_plan(omega: np.ndarray, G, J: int, beta: float):
    """Flat grid index ``(J*J, M)`` int64 and weight ``(J*J, M)`` float64 of
    every tap, ``j1``-major as the JAX loops run (nufft.py:91-100)."""
    G1, G2 = G
    g1 = omega[0] / (2 * np.pi) * G1 + G1 / 2
    g2 = omega[1] / (2 * np.pi) * G2 + G2 / 2
    k1 = np.floor(g1 - J / 2).astype(np.int64)
    k2 = np.floor(g2 - J / 2).astype(np.int64)
    idx, wts = [], []
    for j1 in range(1, J + 1):
        i1, w1 = np.mod(k1 + j1, G1), kb_kernel(g1 - (k1 + j1), J, beta)
        for j2 in range(1, J + 1):
            i2, w2 = np.mod(k2 + j2, G2), kb_kernel(g2 - (k2 + j2), J, beta)
            idx.append(i1 * G2 + i2)
            wts.append(w1 * w2)
    return np.stack(idx), np.stack(wts)


def _as_omega(omega) -> np.ndarray:
    if isinstance(omega, torch.Tensor):
        omega = omega.detach().cpu().numpy()
    return np.asarray(omega, np.float64)


class NufftPlan(nn.Module):
    """Type-2 NUFFT of ``im_size`` images at ``omega`` and its adjoint, with
    the plan (tap indices, weights, deapodization) as buffers, so
    ``plan.to(device)`` moves it.

    :param omega: ``(2, M)`` k-space points in radians (numpy or tensor).
    :param im_size: ``(N1, N2)``.
    :param J: kernel width in grid cells.
    :param osf: oversampling factor.
    """

    def __init__(self, omega, im_size, J: int = 4, osf: float = 2.0):
        super().__init__()
        self.im_size = tuple(int(n) for n in im_size)
        self.grid, beta, scale = _grid_setup(self.im_size, J, osf)
        idx, wts = _interp_plan(_as_omega(omega), self.grid, J, beta)
        # the JAX package's normalization to sum_n x[n] exp(-i omega.n)
        # (nufft.py:101-106)
        self.const = float((J / np.i0(beta)) ** 2)
        self.register_buffer("idx", torch.from_numpy(idx))
        self.register_buffer("wts", torch.from_numpy(wts.astype(np.float32)))
        self.register_buffer("scale", torch.from_numpy(scale))

    def forward(self, x):
        """Type 2: ``(..., N1, N2)`` image -> ``(..., M)`` complex samples."""
        (N1, N2), (G1, G2) = self.im_size, self.grid
        p1, p2 = (G1 - N1) // 2, (G2 - N2) // 2
        xp = F.pad(x.to(torch.complex64) * self.scale, (p2, G2 - N2 - p2, p1, G1 - N1 - p1))
        k = torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(xp, dim=(-2, -1))),
                               dim=(-2, -1))
        taps = k.reshape(k.shape[:-2] + (G1 * G2,))[..., self.idx]   # (..., J*J, M)
        return (taps * self.wts).sum(-2) / self.const

    def adjoint(self, v):
        """Type 1, the adjoint of :meth:`forward`: ``(..., M)`` samples ->
        ``(..., N1, N2)`` complex image."""
        (N1, N2), (G1, G2) = self.im_size, self.grid
        lead, M = v.shape[:-1], v.shape[-1]
        v = (v.to(torch.complex64) / self.const).reshape(-1, 1, M)
        src = (v * self.wts).reshape(v.shape[0], -1)
        grid = torch.zeros((v.shape[0], G1 * G2), dtype=torch.complex64, device=v.device)
        torch.view_as_real(grid).index_add_(1, self.idx.reshape(-1), torch.view_as_real(src))
        grid = torch.fft.ifftshift(grid.reshape(-1, G1, G2), dim=(-2, -1))
        xp = torch.fft.fftshift(torch.fft.ifft2(grid), dim=(-2, -1)) * (G1 * G2)
        p1, p2 = (G1 - N1) // 2, (G2 - N2) // 2
        x = xp[..., p1:p1 + N1, p2:p2 + N2] * self.scale
        return x.reshape(lead + (N1, N2))


def nufft2(x, omega, J: int = 4, osf: float = 2.0):
    """Type-2 NUFFT (nufft.py:70): ``(..., N1, N2)`` image -> ``(..., M)``
    samples at ``omega`` (2, M) radian coordinates."""
    return NufftPlan(omega, x.shape[-2:], J, osf).to(x.device)(x)


def nufft2_adjoint(y, omega, im_size, J: int = 4, osf: float = 2.0):
    """Type-1 NUFFT, the exact adjoint of :func:`nufft2` (nufft.py:109):
    ``(..., M)`` samples -> ``(..., N1, N2)`` complex image."""
    return NufftPlan(omega, im_size, J, osf).to(y.device).adjoint(y)


def nufft2_toeplitz_spec(omega, im_size, weights=None, J: int = 4, osf: float = 2.0):
    """Spectrum ``T`` of the Toeplitz-embedded normal operator
    ``A^H diag(w) A`` for ``A = nufft2(., omega)`` on ``im_size`` images
    (nufft.py:133): one type-1 NUFFT at double size. Apply with
    :func:`nufft2_normal`."""
    N1, N2 = im_size
    G1n, G2n = _next_smooth(2 * N1), _next_smooth(2 * N2)
    plan = NufftPlan(omega, (G1n, G2n), J, osf)
    device = weights.device if isinstance(weights, torch.Tensor) else plan.idx.device
    w = torch.as_tensor(1.0 if weights is None else weights, dtype=torch.complex64)
    k = plan.to(device).adjoint(w.to(device).broadcast_to((plan.idx.shape[-1],)))
    (Gq1, Gq2) = plan.grid
    o1, o2 = Gq1 // 2 - (Gq1 - G1n) // 2, Gq2 // 2 - (Gq2 - G2n) // 2
    return torch.fft.fft2(torch.roll(k, (-o1, -o2), dims=(-2, -1)))


def nufft2_normal(x, spec):
    """Apply ``A^H diag(w) A`` through a Toeplitz spectrum (nufft.py:160):
    embed, two FFTs and a pointwise multiply, crop. Complex output."""
    N1, N2 = x.shape[-2:]
    G1n, G2n = spec.shape[-2:]
    xe = F.pad(x.to(torch.complex64), (0, G2n - N2, 0, G1n - N1))
    return torch.fft.ifft2(torch.fft.fft2(xe) * spec)[..., :N1, :N2]

"""Parallel-beam Radon transform by the Fourier-slice theorem (port of
deepinv_tpu/ops/radon_slice.py).

``P_theta(r) = x_hat(r * omega_theta)``: every projection comes from one
oversampled 2D FFT and a Kaiser-Bessel interpolation at the radial sample
points (:mod:`~deepinv_tpu_torch.ops.nufft`), then per-angle 1D inverse FFTs.
Conventions are ``ops.radon``'s: angles in degrees, ``circle=False`` pads to
the diagonal, sinograms are ``(B, C, n_det, n_angles)``.

:class:`RadonSlicePlan` holds what depends only on the geometry, built once
in float64 numpy (the sampling plan ``_slice_plan`` :45, the NUFFT taps of
``_adjoint_plan`` :119, and optionally the Toeplitz spectrum of ``A^T A``,
``_normal_spec_impl`` :181) as buffers; the functions :func:`radon_slice`
(:68), :func:`radon_slice_adjoint` (:230), :func:`iradon_slice` (:84),
:func:`radon_slice_normal_spec` (:198) and :func:`radon_slice_normal` (:209)
are the JAX package's signatures. The adjoint spreads the taps with
``index_add_``; the JAX package's sorted cumulative sum (:110-114, :250-262)
is a workaround for how XLA scatters on the TPU and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .nufft import NufftPlan, _grid_setup, nufft2_normal, nufft2_toeplitz_spec
from .radon import _circle_mask, _pad_image, radon_output_size, ramp_filter

__all__ = ["RadonSlicePlan", "radon_slice", "radon_slice_adjoint", "iradon_slice",
           "radon_slice_normal_spec", "radon_slice_normal"]


def _slice_plan(W: int, theta_deg, J: int, osf: float):
    """Radial k-space points ``(2, A*W)`` float64 and the phase ``(A, W)``
    complex64 that aligns the NUFFT grid origin with the Radon centre
    (radon_slice.py:45)."""
    r = 2 * np.pi * np.fft.fftfreq(W)
    th = np.deg2rad(np.asarray(theta_deg, np.float64))
    om_row = -np.sin(th)[:, None] * r[None, :]
    om_col = np.cos(th)[:, None] * r[None, :]
    omega = np.stack([om_row.reshape(-1), om_col.reshape(-1)])
    (G1, _), _, _ = _grid_setup((W, W), J, osf)
    origin = G1 // 2 - (G1 - W) // 2
    d = (W - 1) / 2.0 - origin      # the NUFFT phase origin vs the Radon centre
    dt = W // 2 - (W - 1) / 2.0     # ifft places t = 0 at index W // 2
    phase = np.exp(1j * (om_row * d + om_col * d + r[None, :] * dt))
    return omega, phase.astype(np.complex64)


def _normal_weight_spec(omega, W: int, J: int, osf: float):
    """Toeplitz spectrum of ``A^T A``: the sample-space normal weights
    collapse to 1/W (the radial ifft is unitary up to 1/W and the phases have
    unit modulus; radon_slice.py:181-195)."""
    return nufft2_toeplitz_spec(omega, (W, W), weights=1.0 / W, J=J, osf=osf)


def _unpad(xt, out_size: int, circle: bool, mask):
    """Transpose of the padding and masking of the forward
    (radon_slice.py:273-285)."""
    W = xt.shape[-1]
    if circle:
        xt = xt * mask
        b0 = (W - out_size) // 2
        return xt[..., b0:b0 + out_size, b0:b0 + out_size]
    before = W // 2 - out_size // 2
    return xt[..., before:before + out_size, before:before + out_size]


class RadonSlicePlan(nn.Module):
    """The Fourier-slice projector for one geometry: ``W`` detector pixels
    (the padded image width), angles ``theta`` in degrees.

    :param normal: also precompute the ``(Gn, Gn)`` Toeplitz spectrum of
        ``A^T A`` (``spec``; 750 x 750 complex64 for 256-pixel images, not
        circle) for :meth:`normal`.
    """

    def __init__(self, W: int, theta, circle: bool = False, J: int = 4, osf: float = 2.0,
                 normal: bool = False):
        super().__init__()
        self.W, self.circle = int(W), circle
        self.n_angles = len(np.atleast_1d(theta))
        omega, phase = _slice_plan(self.W, theta, J, osf)
        self.nufft = NufftPlan(omega, (self.W, self.W), J, osf)
        self.register_buffer("phase", torch.from_numpy(phase))
        self.register_buffer("mask", torch.from_numpy(_circle_mask(self.W)) if circle else None)
        self.register_buffer("spec", _normal_weight_spec(omega, self.W, J, osf) if normal
                             else None)

    def _pad(self, x):
        x = _pad_image(x, self.circle)
        if x.shape[-1] != self.W:
            raise ValueError(f"image pads to width {x.shape[-1]}, the plan is for {self.W}")
        return x * self.mask if self.circle else x

    def project(self, x):
        """Sinogram ``(..., W, n_angles)`` of ``(..., W0, W0)`` images
        (radon_slice.py:68)."""
        x = self._pad(x)
        S = self.nufft(x).reshape(x.shape[:-2] + (self.n_angles, self.W)) * self.phase
        p = torch.fft.fftshift(torch.fft.ifft(S, dim=-1), dim=-1).real
        return p.movedim(-2, -1).to(x.dtype)

    def backproject(self, sino, out_size: int | None = None):
        """Exact adjoint of :meth:`project` (radon_slice.py:230) onto
        ``out_size`` images (default: the JAX package's, the inscribed size
        when not ``circle``)."""
        W = self.W
        y = torch.fft.ifftshift(sino.movedim(-1, -2).to(torch.complex64), dim=-1)
        S = torch.fft.fft(y, dim=-1) / W * self.phase.conj()
        xt = self.nufft.adjoint(S.reshape(S.shape[:-2] + (self.n_angles * W,))).real
        if out_size is None:
            out_size = W if self.circle else int(np.floor(np.sqrt(W ** 2 / 2.0)))
        return _unpad(xt, out_size, self.circle, self.mask)

    def filtered_backproject(self, sino, out_size: int | None = None, filtered: bool = True):
        """(Filtered) backprojection: the ramp filter, :meth:`backproject`,
        and FBP's ``pi / (2 n_angles)`` scaling (radon_slice.py:84-106)."""
        if filtered:
            sino = ramp_filter(sino)
        return self.backproject(sino, out_size) * (np.pi / (2 * self.n_angles))

    def normal(self, x):
        """``A^T A x`` through the Toeplitz spectrum (radon_slice.py:209)."""
        return _normal(x, self.spec, self.circle, self.mask)


def _normal(x, spec, circle: bool, mask):
    xp = _pad_image(x, circle)
    if circle:
        xp = xp * mask
    out = nufft2_normal(xp, spec).real.to(x.dtype)
    return _unpad(out, x.shape[-1], circle, mask)


def radon_slice(x, theta, circle: bool = False, J: int = 4, osf: float = 2.0):
    """Radon transform ``(B, C, W0, W0) -> (B, C, n_det, n_angles)``
    (radon_slice.py:68)."""
    W = radon_output_size(x.shape[-1], circle)
    return RadonSlicePlan(W, theta, circle, J, osf).to(x.device).project(x)


def radon_slice_adjoint(sino, theta, circle: bool = False, J: int = 4, osf: float = 2.0,
                        out_size: int | None = None):
    """Exact transpose of :func:`radon_slice` (radon_slice.py:230)."""
    plan = RadonSlicePlan(sino.shape[-2], theta, circle, J, osf).to(sino.device)
    return plan.backproject(sino, out_size)


def iradon_slice(sino, theta, circle: bool = False, filtered: bool = True,
                 out_size: int | None = None, J: int = 4, osf: float = 2.0):
    """(Filtered) backprojection matching :func:`radon_slice`
    (radon_slice.py:84): ramp filter, exact adjoint, ``pi / (2 n_angles)``."""
    plan = RadonSlicePlan(sino.shape[-2], theta, circle, J, osf).to(sino.device)
    return plan.filtered_backproject(sino, out_size, filtered)


def radon_slice_normal_spec(img_width: int, theta, circle: bool = False, J: int = 4,
                            osf: float = 2.0):
    """Toeplitz spectrum of ``A^T A`` for :func:`radon_slice` on
    ``img_width`` images with these angles (radon_slice.py:198)."""
    W = radon_output_size(img_width, circle)
    omega, _ = _slice_plan(W, theta, J, osf)
    return _normal_weight_spec(omega, W, J, osf)


def radon_slice_normal(x, spec, circle: bool = False):
    """``A^T A x`` for :func:`radon_slice` through the precomputed spectrum
    (radon_slice.py:209)."""
    W = radon_output_size(x.shape[-1], circle)
    mask = torch.from_numpy(_circle_mask(W)).to(x.device) if circle else None
    return _normal(x, spec, circle, mask)

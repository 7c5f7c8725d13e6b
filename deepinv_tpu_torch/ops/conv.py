"""Blur filters and their transfer functions (port of deepinv_tpu/ops/conv.py).

Only what the PnP-HQS deblurring slice uses: :func:`gaussian_blur` (:313) and
:func:`filter_fft_2d` (:146). Spatial-domain convolutions and the other filter
factories wait for their slices (ROADMAP queue 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["gaussian_blur", "filter_fft_2d"]


def filter_fft_2d(filter: torch.Tensor, img_shape, real_fft: bool = True) -> torch.Tensor:
    """FFT of a centred PSF zero-embedded into the image grid
    (deepinv_tpu/ops/conv.py:146): the transfer function that diagonalizes
    circular convolution. A PSF larger than the grid wraps modulo the grid.

    :param filter: ``(..., h, w)`` real PSF.
    :param img_shape: shape whose last two entries are ``(H, W)``.
    :param real_fft: ``rfft2`` (half spectrum) if True, else the full ``fft2``.
    """
    H, W = img_shape[-2:]
    h, w = filter.shape[-2:]
    ch, cw = h // 2, w // 2  # PSF centre in the original coordinates
    if h > H or w > W:
        filter = torch.nn.functional.pad(filter, (0, (-w) % W, 0, (-h) % H))
        hh, ww = filter.shape[-2:]
        filter = filter.reshape(filter.shape[:-2] + (hh // H, H, ww // W, W)).sum((-4, -2))
        h, w = H, W
    f = filter.new_zeros(filter.shape[:-2] + (H, W))
    f[..., :h, :w] = filter
    f = torch.roll(f, shifts=(-ch, -cw), dims=(-2, -1))
    return torch.fft.rfft2(f) if real_fft else torch.fft.fft2(f)


def gaussian_blur(sigma=(1.0, 1.0), angle: float = 0.0, psf_size=None) -> torch.Tensor:
    """Anisotropic rotated 2D Gaussian PSF of shape ``(1, 1, h, w)`` summing
    to 1 (deepinv_tpu/ops/conv.py:313, 2D with a scalar angle).

    :param sigma: scalar (isotropic) or ``(sigma_h, sigma_w)``.
    :param angle: rotation in degrees.
    :param psf_size: ``int`` or ``(h, w)``; default ``2 * int(max(sigma) / 0.3 + 1) + 1``.
    """
    if isinstance(sigma, (int, float)):
        sigma = (float(sigma), float(sigma))
    sigma = tuple(float(s) for s in sigma)
    if len(sigma) != 2:
        raise NotImplementedError(
            "gaussian_blur ports the 2D PSF only; 1D/3D and batched PSFs wait "
            "for ROADMAP queue 1 item 8")
    if psf_size is None:
        c = int(max(sigma) / 0.3 + 1)
        psf_size = (2 * c + 1,) * 2
    elif isinstance(psf_size, int):
        psf_size = (psf_size, psf_size)
    psf_size = tuple(int(s) for s in psf_size)

    # (x, y) coordinates with x along the last PSF axis, as the JAX package
    grids = [np.linspace(-(n - 1) / 2, (n - 1) / 2, n, dtype=np.float32) for n in psf_size]
    mesh = np.meshgrid(*grids, indexing="ij")
    coords = np.stack(mesh[::-1], axis=-1)  # (h, w, 2) as (x, y)
    a = np.float32(angle * math.pi / 180.0)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]], np.float32)
    coords = np.einsum("ij,...j->...i", rot, coords)
    sig = sigma[::-1]  # (x, y) order
    kernel = np.ones(psf_size, np.float32)
    for d in range(2):
        sd = np.float32(sig[d])
        kernel = kernel * np.exp(-0.5 * coords[..., d] ** 2 / sd ** 2) / (
            math.sqrt(2 * math.pi) * sd)
    kernel = kernel / kernel.sum()
    return torch.from_numpy(np.ascontiguousarray(kernel, np.float32))[None, None]

"""Orthonormal trigonometric transforms and centred FFTs (port of
deepinv_tpu/ops/fourier.py). torch has no DCT, so the DCT-II is the JAX
package's construction on an FFT (the even-odd interleave and a half-sample
twiddle) and its inverse the autograd transpose of the orthonormal forward.
"""

from __future__ import annotations

import math

import torch

from ..core.linalg import linear_transpose

__all__ = ["dct2", "idct2", "dst1", "fftc", "ifftc", "dct1d", "idct1d"]


def dct1d(x: torch.Tensor, axis: int = -1, ortho: bool = True) -> torch.Tensor:
    """DCT-II along ``axis`` (fourier.py:17)."""
    N = x.shape[axis]
    x = x.movedim(axis, -1)
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    V = torch.fft.fft(v, dim=-1)
    k = torch.arange(N, device=x.device)
    factor = 2 * torch.exp(-1j * math.pi * k / (2 * N)).to(V.dtype)
    out = (V * factor).real
    if ortho:
        scale = torch.full((N,), math.sqrt(1.0 / (2 * N)), device=x.device, dtype=out.dtype)
        scale[0] = math.sqrt(1.0 / (4 * N))
        out = out * scale
    return out.movedim(-1, axis)


def idct1d(x: torch.Tensor, axis: int = -1, ortho: bool = True) -> torch.Tensor:
    """Inverse of :func:`dct1d` (fourier.py:34): the orthonormal DCT-II is
    orthogonal, so its inverse is its transpose."""
    if not ortho:
        raise NotImplementedError("idct1d only supports ortho normalization")
    return linear_transpose(lambda v: dct1d(v, axis=axis, ortho=True), x, x.shape)


def dct2(x: torch.Tensor, ortho: bool = True) -> torch.Tensor:
    """2D DCT-II over the last two axes (fourier.py:48)."""
    return dct1d(dct1d(x, axis=-1, ortho=ortho), axis=-2, ortho=ortho)


def idct2(x: torch.Tensor, ortho: bool = True) -> torch.Tensor:
    """Inverse of :func:`dct2` (fourier.py:53)."""
    return idct1d(idct1d(x, axis=-1, ortho=ortho), axis=-2, ortho=ortho)


def dst1(x: torch.Tensor, axes=(-2, -1), ortho: bool = True) -> torch.Tensor:
    """DST-I over ``axes``, self-inverse when ``ortho`` (fourier.py:57)."""
    out = x
    for ax in axes:
        out = _dst1_1d(out, ax, ortho)
    return out


def _dst1_1d(x: torch.Tensor, axis: int, ortho: bool) -> torch.Tensor:
    N = x.shape[axis]
    x = x.movedim(axis, -1)
    zeros = torch.zeros_like(x[..., :1])
    ext = torch.cat([zeros, x, zeros, -x.flip(-1)], dim=-1)   # odd extension, 2(N + 1)
    out = -torch.fft.fft(ext, dim=-1)[..., 1:N + 1].imag / 2
    out = out * (math.sqrt(2.0 / (N + 1)) if ortho else 2)
    return out.movedim(-1, axis)


def fftc(x: torch.Tensor, axes=(-2, -1)) -> torch.Tensor:
    """Centred orthonormal FFT, the MRI convention (fourier.py:84)."""
    return torch.fft.fftshift(torch.fft.fftn(torch.fft.ifftshift(x, dim=axes), dim=axes,
                                             norm="ortho"), dim=axes)


def ifftc(x: torch.Tensor, axes=(-2, -1)) -> torch.Tensor:
    """Inverse of :func:`fftc` (fourier.py:92)."""
    return torch.fft.fftshift(torch.fft.ifftn(torch.fft.ifftshift(x, dim=axes), dim=axes,
                                              norm="ortho"), dim=axes)

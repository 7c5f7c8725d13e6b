"""Convolutions with deepinv padding semantics, blur filters and their
transfer functions (port of deepinv_tpu/ops/conv.py).

- :func:`conv2d` (:98) is a *true* convolution (the filter flipped) unless
  ``correlation=True``, grouped per (batch, channel), with the padding modes
  ``valid`` (the output shrinks), ``circular``, ``replicate``, ``reflect``
  and ``constant``/``zeros`` (the output keeps the input's size); a filter
  ``(b, c, h, w)`` broadcasts with b in {1, B} and c in {1, C}.
- :func:`conv_transpose2d` (:129) is its exact adjoint in every mode, the
  padding's adjoint included: the JAX package takes ``jax.linear_transpose``
  of the forward map, the port the autograd vector-Jacobian product of
  :func:`conv2d`, which is the same linear transpose.
- The filter factories :func:`gaussian_blur` (:313, the 2D PSF),
  :func:`bilinear_filter` (:418), :func:`bicubic_filter` (:428),
  :func:`kaiser_window` (:440) and :func:`sinc_filter` (:450), built on the
  host with numpy; :func:`filter_fft_2d` (:146).

The 3D convolutions and the FFT convolutions wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["conv2d", "conv_transpose2d", "filter_fft_2d", "gaussian_blur", "bilinear_filter",
           "bicubic_filter", "kaiser_window", "sinc_filter"]

# padding mode -> torch.nn.functional.pad mode
_PAD_MODES = {"circular": "circular", "replicate": "replicate", "reflect": "reflect",
              "constant": "constant"}


def _check_padding(padding: str) -> str:
    """The padding mode in its canonical name (conv.py:60): ``zeros`` is
    ``constant``."""
    padding = padding.lower()
    if padding == "zeros":
        padding = "constant"
    if padding not in ("valid", "circular", "replicate", "reflect", "constant"):
        raise ValueError(f"padding={padding!r} not implemented; use 'valid', 'circular', "
                         "'replicate', 'reflect', 'constant' or 'zeros'.")
    return padding


def _broadcast_filter(filt: torch.Tensor, B: int, C: int, nd: int = 2) -> torch.Tensor:
    """A filter ``(b, c, *k)`` with b in {1, B}, c in {1, C} broadcast to
    ``(B, C, *k)`` (conv.py:72); leading dimensions it lacks are added."""
    while filt.dim() < nd + 2:
        filt = filt[None]
    b, c = filt.shape[:2]
    if b not in (1, B) or c not in (1, C):
        raise ValueError(f"filter batch/channel dims {(b, c)} incompatible with input {(B, C)}")
    return filt.expand((B, C) + tuple(filt.shape[2:]))


def _pad_same(x: torch.Tensor, ksizes, padding: str) -> torch.Tensor:
    """Pad the spatial dimensions so that a 'valid' convolution keeps the
    input's size (conv.py:84): ``k // 2 - (k - 1) % 2`` before, ``k // 2``
    after."""
    pads = []
    for k in reversed(ksizes):  # F.pad lists the last dimension first
        p, i = k // 2, (k - 1) % 2
        pads += [p - i, p]
    return F.pad(x, pads, mode=_PAD_MODES[padding])


def conv2d(x: torch.Tensor, filter: torch.Tensor, padding: str = "valid",
           correlation: bool = False) -> torch.Tensor:
    """2D convolution of ``x`` ``(B, C, H, W)`` with ``filter`` ``(b, c, h, w)``,
    one group per (batch, channel) pair (conv.py:98).

    :param padding: ``valid``, ``circular``, ``replicate``, ``reflect``,
        ``constant`` or ``zeros``.
    :param correlation: cross-correlate (no flip).
    """
    padding = _check_padding(padding)
    B, C = x.shape[:2]
    filt = _broadcast_filter(filter.to(x.dtype), B, C)
    h, w = filt.shape[-2:]
    if not correlation:
        filt = filt.flip((-2, -1))
    if padding != "valid":
        x = _pad_same(x, (h, w), padding)
    out = F.conv2d(x.reshape(1, B * C, *x.shape[-2:]), filt.reshape(B * C, 1, h, w),
                   groups=B * C)
    return out.reshape(B, C, *out.shape[-2:])


def conv_transpose2d(y: torch.Tensor, filter: torch.Tensor, padding: str = "valid",
                     correlation: bool = False) -> torch.Tensor:
    """Exact adjoint of :func:`conv2d` in the same padding mode (conv.py:129):
    the vector-Jacobian product of :func:`conv2d` at ``y``, computed by
    autograd (differentiable in ``y`` and ``filter`` where they require
    grad)."""
    padding = _check_padding(padding)
    B, C = y.shape[:2]
    filt = _broadcast_filter(filter, B, C)
    h, w = filt.shape[-2:]
    x_shape = (B, C, y.shape[-2] + h - 1, y.shape[-1] + w - 1) if padding == "valid" else y.shape
    with torch.enable_grad():
        x = y.new_zeros(x_shape).requires_grad_()
        out = conv2d(x, filt, padding=padding, correlation=correlation)
        (xt,) = torch.autograd.grad(out, x, y,
                                    create_graph=y.requires_grad or filter.requires_grad)
    return xt


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


def _psf(w2d: np.ndarray) -> torch.Tensor:
    """A host-side 2D PSF as a ``(1, 1, h, w)`` float32 tensor summing to 1."""
    return torch.from_numpy(np.ascontiguousarray(w2d / np.sum(w2d), np.float32))[None, None]


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


def bilinear_filter(factor: int = 2) -> torch.Tensor:
    """Bilinear antialiasing filter ``(1, 1, 2f, 2f)`` (conv.py:418)."""
    x = np.arange(-factor + 0.5, factor, 1.0) / factor
    w = 1.0 - np.abs(x)
    return _psf(np.outer(w, w))


def bicubic_filter(factor: int = 2) -> torch.Tensor:
    """Bicubic filter ``(1, 1, 4f, 4f)`` (conv.py:428), Keys' kernel at a = -0.5."""
    x = np.abs(np.arange(-2 * factor + 0.5, 2 * factor, 1.0) / factor)
    a = -0.5
    w = ((a + 2) * x ** 3 - (a + 3) * x ** 2 + 1) * (x <= 1)
    w = w + (a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a) * ((x > 1) & (x < 2))
    return _psf(np.outer(w, w))


def kaiser_window(beta: float, length: int) -> np.ndarray:
    """Kaiser window of ``length`` taps (conv.py:440), host-side numpy."""
    n = np.arange(length) - (length - 1) / 2
    arg = beta * np.sqrt(np.clip(1 - (2 * n / (length - 1)) ** 2, 0.0, None))
    return np.i0(arg) / np.i0(beta)


def sinc_filter(factor: float = 2, length: int = 11, windowed: bool = True) -> torch.Tensor:
    """Anti-aliasing sinc filter ``(1, 1, length, length)``, Kaiser-windowed
    by default (conv.py:450)."""
    factor = float(factor)
    deltaf = 2 * (2 - 1.4142136) / factor
    n = np.arange(length) - (length - 1) / 2
    filt = np.sinc(n / factor)
    if windowed:
        A = 2.285 * (length - 1) * 3.14159 * deltaf + 7.95
        if A <= 21:
            beta = 0.0
        elif A <= 50:
            beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21)
        else:
            beta = 0.1102 * (A - 8.7)
        filt = filt * kaiser_window(beta, length)
    return _psf(np.outer(filt, filt))

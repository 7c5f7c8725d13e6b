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
- :func:`conv3d` (:229) and :func:`conv_transpose3d` (:260) likewise on
  ``(B, C, D, H, W)``; the FFT convolutions :func:`conv2d_fft` (:175,
  ``circular`` exact, ``valid`` a linear convolution cropped, the other modes
  padded first), :func:`conv3d_fft` (:278, circular) and their transposes
  :func:`conv_transpose2d_fft` (:210) and :func:`conv_transpose3d_fft`
  (:300). Every transpose is the autograd one
  (:func:`~deepinv_tpu_torch.core.linear_transpose`).
- The filter factories :func:`gaussian_blur` (:313: 1D, 2D and 3D, batched
  sigmas and angles), :func:`bilinear_filter` (:418), :func:`bicubic_filter`
  (:428), :func:`kaiser_window` (:440) and :func:`sinc_filter` (:450), built
  on the host with numpy; :func:`filter_fft_2d` (:146).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.linalg import linear_transpose

__all__ = ["conv2d", "conv_transpose2d", "conv3d", "conv_transpose3d", "conv2d_fft",
           "conv_transpose2d_fft", "conv3d_fft", "conv_transpose3d_fft", "filter_fft_2d",
           "gaussian_blur", "bilinear_filter", "bicubic_filter", "kaiser_window", "sinc_filter"]

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
    return linear_transpose(lambda x: conv2d(x, filt, padding=padding, correlation=correlation),
                            y, x_shape, create_graph=filter.requires_grad)


def conv3d(x: torch.Tensor, filter: torch.Tensor, padding: str = "valid",
           correlation: bool = False) -> torch.Tensor:
    """3D convolution of ``x`` ``(B, C, D, H, W)`` with ``filter`` ``(b, c,
    d, h, w)``, one group per (batch, channel) pair (conv.py:229), in the
    padding modes of :func:`conv2d`."""
    padding = _check_padding(padding)
    B, C = x.shape[:2]
    filt = _broadcast_filter(filter.to(x.dtype), B, C, nd=3)
    d, h, w = filt.shape[-3:]
    if not correlation:
        filt = filt.flip((-3, -2, -1))
    if padding != "valid":
        x = _pad_same(x, (d, h, w), padding)
    out = F.conv3d(x.reshape(1, B * C, *x.shape[-3:]), filt.reshape(B * C, 1, d, h, w),
                   groups=B * C)
    return out.reshape(B, C, *out.shape[-3:])


def conv_transpose3d(y: torch.Tensor, filter: torch.Tensor, padding: str = "valid",
                     correlation: bool = False) -> torch.Tensor:
    """Exact adjoint of :func:`conv3d` in the same padding mode (conv.py:260)."""
    padding = _check_padding(padding)
    B, C = y.shape[:2]
    filt = _broadcast_filter(filter, B, C, nd=3)
    d, h, w = filt.shape[-3:]
    x_shape = ((B, C, y.shape[-3] + d - 1, y.shape[-2] + h - 1, y.shape[-1] + w - 1)
               if padding == "valid" else y.shape)
    return linear_transpose(lambda x: conv3d(x, filt, padding=padding, correlation=correlation),
                            y, x_shape, create_graph=filter.requires_grad)


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


def conv2d_fft(x: torch.Tensor, filter: torch.Tensor, padding: str = "circular",
               real_fft: bool = True) -> torch.Tensor:
    """Convolution by the FFT (conv.py:175): ``circular`` is exact circular
    convolution (complex output when ``real_fft`` is False), ``valid`` the
    linear convolution cropped to its valid part, any other mode pads to
    the same size first."""
    padding = _check_padding(padding)
    B, C = x.shape[:2]
    filt = _broadcast_filter(filter, B, C)
    h, w = filt.shape[-2:]
    if padding == "circular":
        Fk = filter_fft_2d(filt, x.shape, real_fft=real_fft)
        if real_fft:
            return torch.fft.irfft2(torch.fft.rfft2(x) * Fk, s=x.shape[-2:]).to(x.dtype)
        return torch.fft.ifft2(torch.fft.fft2(x) * Fk)
    if padding == "valid":
        H, W = x.shape[-2:]
        fpad = F.pad(filt, (0, W - w, 0, H - h))
        full = torch.fft.irfft2(torch.fft.rfft2(x) * torch.fft.rfft2(fpad), s=(H, W))
        return full[..., h - 1:H, w - 1:W].to(x.dtype)
    return conv2d_fft(_pad_same(x, (h, w), padding), filt, padding="valid", real_fft=real_fft)


def conv_transpose2d_fft(y: torch.Tensor, filter: torch.Tensor, padding: str = "circular",
                         real_fft: bool = True) -> torch.Tensor:
    """Exact adjoint of :func:`conv2d_fft` (conv.py:210)."""
    padding = _check_padding(padding)
    B, C = y.shape[:2]
    filt = _broadcast_filter(filter, B, C)
    h, w = filt.shape[-2:]
    x_shape = (B, C, y.shape[-2] + h - 1, y.shape[-1] + w - 1) if padding == "valid" else y.shape
    return linear_transpose(lambda x: conv2d_fft(x, filt, padding=padding, real_fft=real_fft),
                            y, x_shape, create_graph=filter.requires_grad)


def conv3d_fft(x: torch.Tensor, filter: torch.Tensor, padding: str = "circular",
               real_fft: bool = True) -> torch.Tensor:
    """3D circular convolution of ``(B, C, D, H, W)`` by the FFT (conv.py:278)."""
    padding = _check_padding(padding)
    if padding != "circular":
        raise NotImplementedError("conv3d_fft currently supports circular padding")
    B, C = x.shape[:2]
    filt = _broadcast_filter(filter, B, C, nd=3)
    d, h, w = filt.shape[-3:]
    D, H, W = x.shape[-3:]
    f = torch.roll(F.pad(filt, (0, W - w, 0, H - h, 0, D - d)),
                   shifts=(-(d // 2), -(h // 2), -(w // 2)), dims=(-3, -2, -1))
    dims = (-3, -2, -1)
    if real_fft:
        return torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * torch.fft.rfftn(f, dim=dims),
                                s=(D, H, W), dim=dims)
    return torch.fft.ifftn(torch.fft.fftn(x, dim=dims) * torch.fft.fftn(f, dim=dims), dim=dims)


def conv_transpose3d_fft(y: torch.Tensor, filter: torch.Tensor, padding: str = "circular",
                         real_fft: bool = True) -> torch.Tensor:
    """Exact adjoint of :func:`conv3d_fft` (conv.py:300)."""
    return linear_transpose(lambda x: conv3d_fft(x, filter, padding=padding, real_fft=real_fft),
                            y, y.shape, create_graph=filter.requires_grad)


def _psf(w2d: np.ndarray) -> torch.Tensor:
    """A host-side 2D PSF as a ``(1, 1, h, w)`` float32 tensor summing to 1."""
    return torch.from_numpy(np.ascontiguousarray(w2d / np.sum(w2d), np.float32))[None, None]


def gaussian_blur(sigma=(1.0, 1.0), angle=0.0, psf_size=None) -> torch.Tensor:
    """Anisotropic rotated Gaussian PSFs ``(B, 1, *psf_size)``, each summing
    to 1 (deepinv_tpu/ops/conv.py:313), built on the host with numpy (a
    tensor argument is read to the host).

    :param sigma: a scalar (an isotropic 2D PSF), a tuple whose length is the
        dimension (1, 2 or 3), or an array ``(B, dim)`` in (depth, height,
        width) order.
    :param angle: degrees: a scalar, ``(B,)`` in 2D, or ``(B, 3)`` of
        (gamma, beta, alpha) rotations about the x, y, z axes in 3D.
    :param psf_size: ``int`` (2D) or a tuple; default ``2 * int(max(sigma) /
        0.3 + 1) + 1`` on each axis (``psf_size`` is required with an array
        sigma).
    """
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v

    sigma, angle = host(sigma), host(angle)
    if isinstance(sigma, (int, float)):
        sigma = (float(sigma), float(sigma))
    if psf_size is None:
        if isinstance(sigma, np.ndarray):
            raise ValueError("psf_size is required when sigma is an array")
        c = int(max(sigma) / 0.3 + 1)
        psf_size = (2 * c + 1,) * len(sigma)
    elif isinstance(psf_size, int):
        psf_size = (psf_size, psf_size)
    psf_size = tuple(int(s) for s in psf_size)
    dim = len(psf_size)
    if dim not in (1, 2, 3):
        raise ValueError("Only 1D, 2D, and 3D kernels are supported.")
    # sigma -> (B, dim), angle -> (B,) in 2D, (B, 3) in 3D
    B = 1
    if isinstance(sigma, np.ndarray) and sigma.ndim == 2:
        B = sigma.shape[0]
    if isinstance(angle, np.ndarray) and angle.ndim >= 1 and angle.shape[0] > B:
        B = angle.shape[0]
    if isinstance(sigma, (tuple, list)):
        if len(sigma) != dim:
            raise ValueError(f"len(sigma) must match psf_size dimension {dim}")
        sig = np.asarray([list(map(float, sigma))] * B, np.float32)
    else:
        sig = np.broadcast_to(np.asarray(sigma, np.float32).reshape(-1, dim), (B, dim))
    if isinstance(angle, (int, float)):
        ang = (np.full((B,), float(angle), np.float32) if dim <= 2
               else np.asarray([[float(angle), 0.0, 0.0]] * B, np.float32))
    elif isinstance(angle, (tuple, list)):
        ang = np.asarray([list(map(float, angle))] * B, np.float32)
    else:
        ang = np.broadcast_to(np.asarray(angle, np.float32).reshape(B, -1),
                              (B, 3 if dim == 3 else 1))
        if dim == 2:
            ang = ang.reshape(B)
    ang = ang * (math.pi / 180.0)
    # (x, y, z) coordinates, x along the last PSF axis
    grids = [np.linspace(-(n - 1) / 2, (n - 1) / 2, n, dtype=np.float32) for n in psf_size]
    mesh = np.meshgrid(*grids, indexing="ij")
    coords = np.broadcast_to(np.stack(mesh[::-1], axis=-1)[None], (B, *psf_size, dim))
    sig = sig[:, ::-1]                                    # (x, y, z) order
    if dim == 2:
        c, s = np.cos(ang), np.sin(ang)
        rot = np.stack([c, -s, s, c], axis=1).reshape(B, 2, 2)
        coords = np.einsum("bij,b...j->b...i", rot, coords)
    elif dim == 3:
        g, b_, a = ang[:, 0], ang[:, 1], ang[:, 2]
        ca, sa, cb, sb, cg, sg = np.cos(a), np.sin(a), np.cos(b_), np.sin(b_), np.cos(g), np.sin(g)
        R = np.stack([ca * cb, ca * sb * sg - sa * cg, ca * sb * cg + sa * sg,
                      sa * cb, sa * sb * sg + ca * cg, sa * sb * cg - ca * sg,
                      -sb, cb * sg, cb * cg], axis=1).reshape(B, 3, 3)
        coords = np.einsum("bij,b...j->b...i", R, coords)
    kernel = np.ones((B, *psf_size), np.float32)
    for d in range(dim):
        sd = sig[:, d].reshape(B, *(1,) * dim)
        kernel = kernel * np.exp(-0.5 * coords[..., d] ** 2 / sd ** 2) / (
            math.sqrt(2 * math.pi) * sd)
    kernel = kernel / np.sum(kernel, axis=tuple(range(1, dim + 1)), keepdims=True)
    return torch.from_numpy(np.ascontiguousarray(kernel[:, None], np.float32))


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

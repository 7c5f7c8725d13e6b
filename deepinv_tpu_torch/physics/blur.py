"""Blur and super-resolution physics (port of deepinv_tpu/physics/blur.py):
:class:`Blur` (:63, spatial convolution in five padding modes),
:class:`BlurFFT` (:88, circular blur diagonalized by the FFT),
:class:`Downsampling` (:214, filter then decimate, with the closed-form FFT
polyphase ``prox_l2``) and :class:`Upsampling` (:351).

BlurFFT's real inputs always take the half-spectrum (rfft) closed forms
(blur.py:182-211): cuFFT's and pocketfft's rfft are genuine half-size
transforms. The JAX package gated them per backend (``_RFFT_BACKENDS``,
blur.py:42) because the TPU lowers rfft to full complex FFTs. Complex inputs
take the generic SVD path of :class:`DecomposablePhysics`. ``Blur``,
``Upsampling``, and ``Downsampling`` outside its FFT closed form, solve
their ``prox_l2`` by the Krylov solver of :class:`LinearPhysics`.
A 5-D filter makes :class:`Blur` volumetric (``conv3d``).
:class:`SpaceVaryingBlur` (:366) is a product convolution and
:class:`DownsamplingMatlab` (:396) MATLAB's ``imresize``, both with the
autograd transpose as adjoint, and so is :class:`TiledSpaceVaryingBlur`
(:441), a blur of one PSF a tile blended by a partition of unity, on
:class:`~deepinv_tpu_torch.utils.mixins.TiledMixin2d`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.linalg import linear_transpose
from ..device import resolve_device
from ..ops.conv import (bicubic_filter, bilinear_filter, conv2d, conv3d, conv_transpose2d,
                        conv_transpose3d, filter_fft_2d, gaussian_blur, sinc_filter)
from ..ops.imresize import imresize_matlab
from ..ops.product_convolution import product_convolution2d, product_convolution2d_adjoint
from ..utils.mixins import TiledMixin2d
from .base import (DecomposablePhysics, LinearPhysics, _add_inv_gamma, _inv_gamma_mul,
                   replace)

__all__ = ["Blur", "BlurFFT", "Downsampling", "Upsampling", "SpaceVaryingBlur",
           "DownsamplingMatlab", "TiledSpaceVaryingBlur"]


def _resolve_filter(filter, factor: int = 2):
    """Map a filter name or array to a PSF tensor (blur.py:45)."""
    if isinstance(filter, str):
        if filter == "gaussian":
            return gaussian_blur(sigma=(factor, factor))
        if filter == "bilinear":
            return bilinear_filter(factor)
        if filter == "bicubic":
            return bicubic_filter(factor)
        if filter == "sinc":
            # length scales with the factor (blur.py:55)
            return sinc_filter(factor, length=4 * factor)
        raise ValueError(f"unknown filter {filter!r}")
    if filter is None:
        return None
    return torch.as_tensor(filter, dtype=torch.float32)


def _per_sample(gamma, x):
    """``gamma`` as it is if a number (no device copy), else as a tensor on
    ``x``'s device broadcast over its trailing dimensions (blur.py:327-329)."""
    if isinstance(gamma, (int, float)):
        return gamma
    g = torch.as_tensor(gamma, device=x.device)
    return g.reshape(g.shape + (1,) * (x.dim() - g.dim()))


class Blur(LinearPhysics):
    r"""Blur ``y = h * x`` by spatial convolution (deepinv_tpu/physics/blur.py:63).

    :param filter: PSF ``(b, c, h, w)`` with b in {1, B}, c in {1, C}, a
        volumetric PSF ``(b, c, d, h, w)`` for ``(B, C, D, H, W)`` inputs, or
        a filter name (``gaussian``, ``bilinear``, ``bicubic``, ``sinc``).
    :param padding: ``valid``, ``circular`` (default), ``replicate``,
        ``reflect`` or ``constant``.
    :param noise_model: e.g. :class:`~deepinv_tpu_torch.physics.GaussianNoise`.
    :param device: where the filter lives; the CUDA device by default.
    :param kwargs: ``solver``, ``max_iter``, ``tol`` of the Krylov
        ``prox_l2`` and ``A_dagger`` (:class:`LinearPhysics`).
    """

    def __init__(self, filter=None, padding: str = "circular", noise_model=None, device=None,
                 **kwargs):
        super().__init__(noise_model=noise_model, **kwargs)
        self.register_buffer("filter", _resolve_filter(filter))
        self.padding = padding
        self.to(resolve_device(device))

    def _psf(self, filter, x):
        return self.filter if filter is None else _resolve_filter(filter).to(x.device)

    def A(self, x, filter=None, **params):
        f = self._psf(filter, x)
        conv = conv3d if f.dim() == 5 else conv2d
        return conv(x, f, padding=self.padding)

    def A_adjoint(self, y, filter=None, **params):
        f = self._psf(filter, y)
        conv_t = conv_transpose3d if f.dim() == 5 else conv_transpose2d
        return conv_t(y, f, padding=self.padding)


def _fft_input(x):
    """``x``, or its float32 copy where it is bf16 or fp16: cuFFT (and the
    JAX package's FFT) take no half-precision input of these sizes, and a
    network run under ``torch.autocast`` hands the physics bf16 tensors. The
    result is then float32, as a promoted op's."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


class BlurFFT(DecomposablePhysics):
    r"""Circular blur ``A = F^* diag(Fh) F`` (deepinv_tpu/physics/blur.py:88).

    :param img_size: ``(C, H, W)``.
    :param filter: PSF ``(b, c, h, w)``; its full-spectrum transfer function
        is kept as the complex buffer ``mask`` (blur.py:117-123).
    :param noise_model: e.g. :class:`~deepinv_tpu_torch.physics.GaussianNoise`.
    :param device: where the buffers (filter, mask, noise level) live; the
        CUDA device by default (:func:`~deepinv_tpu_torch.device.resolve_device`).
    """

    def __init__(self, img_size, filter=None, noise_model=None, device=None):
        self.img_size = tuple(img_size)
        filt = _resolve_filter(filter)
        super().__init__(mask=self._compute_mask(filt), noise_model=noise_model)
        self.register_buffer("filter", filt)
        self.to(resolve_device(device))

    def _compute_mask(self, filt):
        return 1.0 if filt is None else filter_fft_2d(filt, self.img_size, real_fft=False)

    def update(self, **params):
        if params.get("filter") is not None:
            params = dict(params)
            f = _resolve_filter(params.pop("filter"))
            if self.filter is not None:
                f = f.to(self.filter.device)
            new = replace(self, filter=f, mask=self._compute_mask(f))
            return new.update(**params) if params else new
        return super().update(**params)

    def V_adjoint(self, x):
        return torch.fft.fft2(_fft_input(x), norm="ortho")

    def V(self, x):
        return torch.fft.ifft2(x, norm="ortho").real

    def U(self, x):
        return torch.fft.ifft2(x, norm="ortho").real

    def U_adjoint(self, x):
        return torch.fft.fft2(_fft_input(x), norm="ortho")

    # -- rfft paths (blur.py:155-211) ----------------------------------------
    # The PSF is real, so its transfer function is Hermitian: the first
    # W//2+1 columns of the full-spectrum mask are its rfft2.

    def _mask_r(self):
        return self.mask[..., : self.img_size[-1] // 2 + 1]

    def _rfft_ok(self, *xs):
        return isinstance(self.mask, torch.Tensor) and not any(x.is_complex() for x in xs)

    def A(self, x, **params):
        phys = self.update(**params) if params else self
        if not phys._rfft_ok(x):
            return super(BlurFFT, phys).A(x)
        return torch.fft.irfft2(torch.fft.rfft2(_fft_input(x)) * phys._mask_r(),
                                s=phys.img_size[-2:])

    def A_adjoint(self, y, **params):
        phys = self.update(**params) if params else self
        if not phys._rfft_ok(y):
            return super(BlurFFT, phys).A_adjoint(y)
        return torch.fft.irfft2(torch.fft.rfft2(_fft_input(y)) * phys._mask_r().conj(),
                                s=phys.img_size[-2:])

    def prox_l2(self, z, y, gamma, **kwargs):
        """Closed-form prox of ``gamma/2 ||Ax-y||^2`` about ``z``, solved per
        rfft bin (blur.py:197)."""
        if z is None or isinstance(z, (int, float)) or not self._rfft_ok(z, y):
            return super().prox_l2(z, y, gamma, **kwargs)
        mr = self._mask_r()
        bf = mr.conj() * torch.fft.rfft2(_fft_input(y)) \
            + _inv_gamma_mul(gamma, torch.fft.rfft2(_fft_input(z)))
        scaling = _add_inv_gamma((mr.conj() * mr).real, gamma)
        return torch.fft.irfft2(bf / scaling, s=self.img_size[-2:])


class Downsampling(LinearPhysics):
    r"""``y = S(h * x)``: an anti-aliasing filter, then decimation by
    ``factor`` (deepinv_tpu/physics/blur.py:214).

    :param img_size: ``(C, H, W)`` of the high-resolution image.
    :param filter: None, ``gaussian``, ``bilinear``, ``bicubic``, ``sinc`` or
        a PSF ``(b, c, h, w)``.
    :param factor: integer decimation factor.
    :param padding: the convolution's padding mode.
    :param noise_model: e.g. :class:`~deepinv_tpu_torch.physics.GaussianNoise`.
    :param device: where the filter lives; the CUDA device by default.
    :param kwargs: ``solver``, ``max_iter``, ``tol`` of the Krylov
        ``prox_l2`` and ``A_dagger`` (:class:`LinearPhysics`).
    """

    def __init__(self, img_size=None, filter=None, factor: int = 2, padding: str = "circular",
                 noise_model=None, device=None, **kwargs):
        super().__init__(noise_model=noise_model, **kwargs)
        self.factor = int(factor)
        self.imsize = tuple(img_size) if img_size is not None else None
        self.padding = padding
        self.register_buffer("filter", _resolve_filter(filter, self.factor))
        self.to(resolve_device(device))

    @staticmethod
    def check_factor(factor) -> int:
        """A downsampling factor as an int (blur.py:248): a 1D tensor or array
        must hold one value."""
        if isinstance(factor, (int, float)):
            return int(factor)
        vals = torch.as_tensor(factor).cpu()
        if vals.dim() > 1:
            raise ValueError("Factor tensor must be 1D.")
        vals = vals.reshape(-1)
        if vals.numel() == 0 or not bool((vals == vals[0]).all()):
            raise ValueError("Downsampling only supports one factor per batch.")
        return int(vals[0])

    @staticmethod
    def get_filter_parameters(img_size=None, filter=None, factor=None, **kwargs) -> dict:
        """``{"filter", "factor"}`` for a given factor (blur.py:267)."""
        f = Downsampling.check_factor(factor) if factor is not None else None
        out = {"filter": _resolve_filter(filter, f if f is not None else 2)}
        if f is not None:
            out["factor"] = f
        return out

    def _resolved(self, filter, factor, like):
        fac = self.factor if factor is None else self.check_factor(factor)
        f = self.filter if filter is None else _resolve_filter(filter, fac)
        return fac, (None if f is None else f.to(like.device))

    def A(self, x, filter=None, factor=None, **params):
        fac, f = self._resolved(filter, factor, x)
        if f is not None:
            x = conv2d(x, f, padding=self.padding)
        return x[:, :, ::fac, ::fac]

    def A_adjoint(self, y, filter=None, factor=None, **params):
        fac, f = self._resolved(filter, factor, y)
        if self.imsize is not None:
            C, H, W = self.imsize
        else:
            C, H, W = y.shape[1], y.shape[-2] * fac, y.shape[-1] * fac
        if f is not None and self.padding == "valid":
            H, W = H - f.shape[-2] + 1, W - f.shape[-1] + 1
        x = y.new_zeros((y.shape[0], C, H, W))
        x[:, :, ::fac, ::fac] = y
        if f is not None:
            x = conv_transpose2d(x, f, padding=self.padding)
        return x

    def prox_l2(self, z, y, gamma, use_fft: bool = True, **kwargs):
        r"""``argmin_x gamma/2 ||Ax - y||^2 + 1/2 ||x - z||^2`` in closed form
        by the FFT polyphase decomposition, for circular padding and a size
        the factor divides (Zhu & Milanfar 2014; blur.py:307); elsewhere by
        the Krylov solver of :meth:`LinearPhysics.prox_l2` (blur.py:311,319)."""
        if not (use_fft and self.padding == "circular" and self.filter is not None):
            return LinearPhysics.prox_l2(self, z, y, gamma, **kwargs)
        if z is None or isinstance(z, (int, float)):
            z = torch.full_like(self.A_adjoint(y), 0.0 if z is None else float(z))
        sf = self.factor
        B, C, H, W = z.shape
        if H % sf or W % sf:
            return LinearPhysics.prox_l2(self, z, y, gamma, **kwargs)
        Fh = filter_fft_2d(self.filter, (C, H, W), real_fft=False)
        Fh2 = (Fh.conj() * Fh).real

        def splits_mean(a):
            # (B, C, H, W) -> the mean over the sf x sf distinct polyphase blocks
            return a.reshape(B, C, sf, H // sf, sf, W // sf).mean((2, 4))

        g = _per_sample(gamma, z)
        z_hat = self.A_adjoint(y) + z / g
        Fz_hat = torch.fft.fft2(z_hat)
        top = splits_mean(Fh * Fz_hat)
        below = splits_mean(Fh2.expand(Fz_hat.shape)) + 1.0 / g
        r = torch.fft.ifft2(Fh.conj() * (top / below).repeat(1, 1, sf, sf)).real
        return (z_hat - r) * g


class Upsampling(Downsampling):
    r""":class:`Downsampling` with the roles of ``A`` and ``A_adjoint``
    swapped (deepinv_tpu/physics/blur.py:351): ``A`` fills zeros between the
    samples and applies the transposed filter, ``A_adjoint`` filters and
    decimates. Its ``prox_l2`` is the Krylov one (blur.py:362)."""

    def A(self, x, **params):
        return Downsampling.A_adjoint(self, x, **params)

    def A_adjoint(self, y, **params):
        return Downsampling.A(self, y, **params)

    def prox_l2(self, z, y, gamma, **kwargs):
        return LinearPhysics.prox_l2(self, z, y, gamma, **kwargs)


class SpaceVaryingBlur(LinearPhysics):
    r"""Space-varying blur by product convolution ``y = sum_k h_k * (w_k .
    x)`` (deepinv_tpu/physics/blur.py:366).

    :param filters: PSF branches ``(b, c, K, h, w)``.
    :param multipliers: their spatial weights ``(b, c, K, H, W)``.
    :param padding: the convolutions' padding mode (``valid`` by default).
    :param device: where the filters and multipliers live; the CUDA device by
        default.
    :param kwargs: ``noise_model``, and ``solver``, ``max_iter``, ``tol`` of
        the Krylov ``prox_l2`` (:class:`LinearPhysics`).
    """

    def __init__(self, filters=None, multipliers=None, padding: str = "valid", device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.register_buffer("filters", None if filters is None else
                             torch.as_tensor(filters, dtype=torch.float32))
        self.register_buffer("multipliers", None if multipliers is None else
                             torch.as_tensor(multipliers, dtype=torch.float32))
        self.padding = padding
        self.to(resolve_device(device))

    def A(self, x, filters=None, multipliers=None, **params):
        h = self.filters if filters is None else filters
        w = self.multipliers if multipliers is None else multipliers
        return product_convolution2d(x, w, h, padding=self.padding)

    def A_adjoint(self, y, filters=None, multipliers=None, **params):
        h = self.filters if filters is None else filters
        w = self.multipliers if multipliers is None else multipliers
        return product_convolution2d_adjoint(y, w, h, padding=self.padding)


class DownsamplingMatlab(LinearPhysics):
    r"""Downsampling by MATLAB's antialiased bicubic ``imresize`` by ``1 /
    factor`` (deepinv_tpu/physics/blur.py:396); the adjoint is the autograd
    transpose of the resize.

    :param img_size: ``(C, H, W)`` of the high-resolution image (else the
        adjoint takes ``factor`` times the measurement's size).
    :param factor: the integer downsampling factor.
    :param kwargs: ``noise_model``, and ``solver``, ``max_iter``, ``tol`` of
        the Krylov ``prox_l2`` (:class:`LinearPhysics`).
    """

    def __init__(self, img_size=None, factor: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.factor = self.check_factor(factor)
        self.imsize = tuple(img_size) if img_size is not None else None

    check_factor = staticmethod(Downsampling.check_factor)
    get_filter_parameters = staticmethod(Downsampling.get_filter_parameters)

    def A(self, x, **params):
        return imresize_matlab(x, scale=1.0 / self.factor)

    def A_adjoint(self, y, **params):
        if self.imsize is not None:
            H, W = self.imsize[-2:]
        else:
            H, W = y.shape[-2] * self.factor, y.shape[-1] * self.factor
        return linear_transpose(lambda x: imresize_matlab(x, scale=1.0 / self.factor), y,
                                tuple(y.shape[:2]) + (H, W))


class TiledSpaceVaryingBlur(TiledMixin2d, LinearPhysics):
    r"""Space-varying blur by tiles (deepinv_tpu/physics/blur.py:441):
    ``y = sum_k h_k * (m_k . x)``, with ``m_k`` the blending windows of
    overlapping tiles (a partition of unity) and ``*`` the 'valid' true
    convolution. The adjoint is the autograd transpose.

    :param filters: the tiles' PSFs ``(B, C, K, h, w)``, K tiles in row-major
        order (or pass them at call time).
    :param patch_size: the tile's size.
    :param stride: the stride between tiles (the overlap is ``patch_size -
        stride``).
    :param blending_mode: ``"bump"`` (smooth) or ``"linear"`` (triangular)
        windows.
    :param device: where the filters live; the CUDA device by default.
    """

    def __init__(self, filters=None, patch_size=None, stride=None, blending_mode: str = "bump",
                 device=None, **kwargs):
        super().__init__(patch_size=patch_size, stride=stride, **kwargs)
        self.register_buffer("filters", None if filters is None else
                             torch.as_tensor(filters, dtype=torch.float32))
        if blending_mode not in ("bump", "linear"):
            raise ValueError("blending_mode must be 'bump' or 'linear'")
        self.blending_mode = blending_mode
        self.to(resolve_device(device))

    @staticmethod
    def num_filters(img_size, patch_size, stride):
        """The number of tiles K of an image size (blur.py:466)."""
        H, W = img_size[-2:]
        ph, pw = (patch_size, patch_size) if isinstance(patch_size, int) else patch_size
        sh, sw = (stride, stride) if isinstance(stride, int) else stride
        return (-(-max(H - ph, 0) // sh) + 1) * (-(-max(W - pw, 0) // sw) + 1)

    def _masks(self, H, W, dtype, device):
        """The windows ``(K, Hp, Wp)``, a partition of unity over the padded
        image ``(Hp, Wp)`` (blur.py:475), made on the host."""
        (ph, pw), (sh, sw) = self.patch_size, self.stride

        def wins(L, p, s):
            n = -(-max(L - p, 0) // s) + 1
            Lp = (n - 1) * s + p
            t = np.linspace(-1, 1, p)
            w = 1.0 - np.abs(t) if self.blending_mode == "linear" else \
                np.exp(-1.0 / np.clip(1 - t ** 2, 1e-9, None))
            w = np.clip(w, 1e-12, None)
            Wn = np.zeros((n, Lp))
            for i in range(n):
                Wn[i, i * s:i * s + p] = w
            return Wn / Wn.sum(0, keepdims=True), Lp

        Wy, Hp = wins(H, ph, sh)
        Wx, Wp = wins(W, pw, sw)
        masks = (Wy[:, None, :, None] * Wx[None, :, None, :]).reshape(-1, Hp, Wp)
        return torch.as_tensor(masks, dtype=dtype, device=device), Hp, Wp

    def A(self, x, filters=None, **params):
        h = self.filters if filters is None else filters
        if h is None:
            raise ValueError("filters must be provided")
        B, C, H, W = x.shape
        masks, Hp, Wp = self._masks(H, W, x.dtype, x.device)
        K = masks.shape[0]
        if h.shape[2] != K:
            raise ValueError(f"expected {K} filters for this image size, got {h.shape[2]}")
        kh, kw = h.shape[-2:]
        z = F.pad(x, (0, Wp - W, 0, Hp - H))[:, :, None] * masks       # (B, C, K, Hp, Wp)
        # one depthwise valid convolution of every (b, c, k); flipped, as
        # conv2d correlates and the blur convolves
        filt = h.expand(B, C, K, kh, kw).reshape(B * C * K, 1, kh, kw).flip(-2, -1)
        y = F.conv2d(z.reshape(1, B * C * K, Hp, Wp), filt, groups=B * C * K)
        y = y.reshape(B, C, K, Hp - kh + 1, Wp - kw + 1).sum(2)
        return y[..., :H - kh + 1, :W - kw + 1]

    def A_adjoint(self, y, filters=None, **params):
        h = self.filters if filters is None else filters
        kh, kw = h.shape[-2:]
        shape = tuple(y.shape[:2]) + (y.shape[-2] + kh - 1, y.shape[-1] + kw - 1)
        return linear_transpose(lambda x: self.A(x, filters=h), y, shape)

"""FFT-diagonalized circular blur (port of ``BlurFFT``,
deepinv_tpu/physics/blur.py:88).

Real inputs always take the half-spectrum (rfft) closed forms
(blur.py:182-211): cuFFT's and pocketfft's rfft are genuine half-size
transforms. The JAX package gated them per backend (``_RFFT_BACKENDS``,
blur.py:42) because the TPU lowers rfft to full complex FFTs. Complex inputs
take the generic SVD path of :class:`DecomposablePhysics`.
``Blur``/``Downsampling`` wait for ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.conv import filter_fft_2d, gaussian_blur
from .base import DecomposablePhysics, _add_inv_gamma, _inv_gamma_mul, replace

__all__ = ["BlurFFT"]


def _resolve_filter(filter, factor: int = 2):
    """Map a filter name or array to a PSF tensor (blur.py:45)."""
    if isinstance(filter, str):
        if filter == "gaussian":
            return gaussian_blur(sigma=(factor, factor))
        if filter in ("bilinear", "bicubic", "sinc"):
            raise NotImplementedError(
                f"the {filter!r} filter waits for ROADMAP queue 1 item 5")
        raise ValueError(f"unknown filter {filter!r}")
    if filter is None:
        return None
    return torch.as_tensor(filter, dtype=torch.float32)


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
        return torch.fft.fft2(x, norm="ortho")

    def V(self, x):
        return torch.fft.ifft2(x, norm="ortho").real

    def U(self, x):
        return torch.fft.ifft2(x, norm="ortho").real

    def U_adjoint(self, x):
        return torch.fft.fft2(x, norm="ortho")

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
        return torch.fft.irfft2(torch.fft.rfft2(x) * phys._mask_r(), s=phys.img_size[-2:])

    def A_adjoint(self, y, **params):
        phys = self.update(**params) if params else self
        if not phys._rfft_ok(y):
            return super(BlurFFT, phys).A_adjoint(y)
        return torch.fft.irfft2(torch.fft.rfft2(y) * phys._mask_r().conj(),
                                s=phys.img_size[-2:])

    def prox_l2(self, z, y, gamma, **kwargs):
        """Closed-form prox of ``gamma/2 ||Ax-y||^2`` about ``z``, solved per
        rfft bin (blur.py:197)."""
        if z is None or isinstance(z, (int, float)) or not self._rfft_ok(z, y):
            return super().prox_l2(z, y, gamma, **kwargs)
        mr = self._mask_r()
        bf = mr.conj() * torch.fft.rfft2(y) + _inv_gamma_mul(gamma, torch.fft.rfft2(z))
        scaling = _add_inv_gamma((mr.conj() * mr).real, gamma)
        return torch.fft.irfft2(bf / scaling, s=self.img_size[-2:])

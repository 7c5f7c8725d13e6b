"""Single-coil MRI (port of deepinv_tpu/physics/mri.py).

Images and measurements are real tensors ``(B, 2, ..., H, W)``: channel 0 is
the real part, channel 1 the imaginary part. The k-space transform is the
centred orthonormal FFT ``fftshift . fftn(norm="ortho") . ifftshift``.
:class:`MRI` is a :class:`DecomposablePhysics` whose singular values are the
mask, so its prox is closed-form. ``MultiCoilMRI``, ``DynamicMRI`` and
``SequentialMRI`` wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import torch

from .base import DecomposablePhysics

__all__ = ["MRI", "MRIMixin"]


class MRIMixin:
    """FFT helpers of the MRI physics (mri.py:30-82)."""

    @staticmethod
    def to_complex(x):
        """``(B, 2, ..., H, W)`` real -> ``(B, 1, ..., H, W)`` complex."""
        return torch.complex(x[:, 0:1], x[:, 1:2])

    @staticmethod
    def from_complex(x):
        """``(B, 1, ..., H, W)`` complex -> ``(B, 2, ..., H, W)`` real."""
        return torch.cat([x.real, x.imag], dim=1)

    @staticmethod
    def fft(x, axes=(-2, -1)):
        return torch.fft.fftshift(
            torch.fft.fftn(torch.fft.ifftshift(x, dim=axes), dim=axes, norm="ortho"), dim=axes)

    @staticmethod
    def ifft(x, axes=(-2, -1)):
        return torch.fft.fftshift(
            torch.fft.ifftn(torch.fft.ifftshift(x, dim=axes), dim=axes, norm="ortho"), dim=axes)

    @classmethod
    def im_to_kspace(cls, x, three_d: bool = False):
        axes = (-3, -2, -1) if three_d else (-2, -1)
        return cls.from_complex(cls.fft(cls.to_complex(x), axes=axes))

    @classmethod
    def kspace_to_im(cls, y, three_d: bool = False):
        axes = (-3, -2, -1) if three_d else (-2, -1)
        return cls.from_complex(cls.ifft(cls.to_complex(y), axes=axes))

    @staticmethod
    def rss(x, multicoil: bool = True, keepdim: bool = True):
        """Root-sum-of-squares magnitude (mri.py:68)."""
        mag = x.pow(2).sum(1, keepdim=keepdim).sqrt()
        if multicoil and mag.dim() >= 5:
            mag = mag.pow(2).sum(2, keepdim=keepdim).sqrt()
        return mag

    @staticmethod
    def crop_center(x, shape):
        """Centre-crop the last two dims to ``shape`` (mri.py:76)."""
        H, W = x.shape[-2:]
        h, w = shape
        top, left = (H - h) // 2, (W - w) // 2
        return x[..., top:top + h, left:left + w]


def _check_mask(mask, img_size=None, three_d: bool = False) -> torch.Tensor:
    """The mask as float32 ``(B, 2, ..., H, W)`` with the real/imaginary
    channels duplicated (mri.py:131); all ones of ``img_size`` if None."""
    if mask is None:
        mask = torch.ones(tuple(img_size))
    mask = torch.as_tensor(mask, dtype=torch.float32)
    while mask.dim() < (5 if three_d else 4):
        mask = mask[None]
    if mask.shape[1] == 1:
        mask = torch.cat([mask, mask], dim=1)
    return mask


class MRI(MRIMixin, DecomposablePhysics):
    r"""Single-coil accelerated MRI ``y = M F x`` (mri.py:144).

    :param mask: sampling mask ``(H, W)``, ``(C, H, W)``, ``(B, C, H, W)`` or
        ``(B, C, D, H, W)``; kept as a buffer.
    :param img_size: size of the all-ones mask when ``mask`` is None.
    :param three_d: FFT over three dims for ``(B, C, D, H, W)`` data.
    :param device: where the mask (and the noise level) live.
    """

    def __init__(self, mask=None, img_size=(320, 320), three_d: bool = False, device=None,
                 **kwargs):
        super().__init__(mask=_check_mask(mask, img_size, three_d), **kwargs)
        self.three_d = three_d
        self.to(device)

    def update(self, **params):
        """A new physics; a new ``mask`` is normalized as at construction."""
        if params.get("mask") is not None:
            params["mask"] = _check_mask(params["mask"], three_d=self.three_d).to(
                self.mask.device)
        return super().update(**params)

    def V_adjoint(self, x):
        return self.im_to_kspace(x, three_d=self.three_d)

    def V(self, y):
        return self.kspace_to_im(y, three_d=self.three_d)

    def A_adjoint(self, y, mask=None, mag: bool = False, crop=None, **kwargs):
        """Zero-filled reconstruction (mri.py:185); ``mag`` takes the
        magnitude, ``crop`` a centre crop."""
        phys = self.update(mask=mask) if mask is not None else self
        x = DecomposablePhysics.A_adjoint(phys, y)
        if mag:
            x = self.rss(x, multicoil=False)
        if crop is not None:
            x = self.crop_center(x, crop)
        return x

    def noise(self, y, generator=None):
        """Noise on the sampled k-space only (mri.py:194)."""
        if self.noise_model is None:
            return y
        return self.noise_model(y, generator=generator) * self.mask

"""MRI physics (port of deepinv_tpu/physics/mri.py).

Images and measurements are real tensors ``(B, 2, ..., H, W)``: channel 0 is
the real part, channel 1 the imaginary part. The k-space transform is the
centred orthonormal FFT ``fftshift . fftn(norm="ortho") . ifftshift``.
:class:`MRI` is a :class:`DecomposablePhysics` whose singular values are the
mask, so its prox is closed-form. :class:`MultiCoilMRI` measures each coil's
view ``M F (s_n . x)`` (or its NUFFT at given k-space points), with the
analytic birdcage maps (:func:`birdcage_maps`) or maps that ESPIRiT estimates
from the data (:meth:`MultiCoilMRI.estimate_coil_maps`). :class:`DynamicMRI`
masks each frame of ``(B, 2, T, H, W)`` data, and :class:`SequentialMRI`
averages the frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.nufft import NufftPlan, nufft2_normal, nufft2_toeplitz_spec
from ..utils.mixins import TimeMixin
from .base import DecomposablePhysics, LinearPhysics

__all__ = ["MRI", "MultiCoilMRI", "DynamicMRI", "SequentialMRI", "MRIMixin", "birdcage_maps"]

_EIGH_BATCH = 4096     # ESPIRiT's per-pixel eigenproblems a call of eigh
_ESPIRIT_CHUNK = 32    # ESPIRiT's image-domain kernels a step of the Gram's sum


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

    @staticmethod
    def to_torch_complex(x):
        """``(B, 2, ..., H, W)`` real -> ``(B, ..., H, W)`` complex
        (mri.py:86)."""
        return torch.complex(x[:, 0], x[:, 1])

    @staticmethod
    def from_torch_complex(x):
        """``(B, ..., H, W)`` complex -> ``(B, 2, ..., H, W)`` real
        (mri.py:92)."""
        return torch.stack([x.real, x.imag], dim=1)

    @staticmethod
    def check_mask(mask=None, three_d: bool = False):
        """A mask as ``(B, 2, ..., H, W)`` with the real and imaginary
        channels duplicated (mri.py:98)."""
        return None if mask is None else _check_mask(mask, three_d=three_d)

    def crop(self, x, crop: bool = True, shape=None, rescale: bool = False):
        """The last two dims centre-cropped (or resized, bilinear with
        antialiasing) to ``shape`` or ``self.img_size``; an odd height is
        cropped one row taller and then cut (mri.py:105)."""
        size = tuple(shape[-2:]) if shape is not None else tuple(self.img_size[-2:])
        odd_h = size[0] % 2 == 1
        if odd_h:
            size = (size[0] + 1, size[1])
        if rescale and crop:
            raise ValueError("Only one of rescale or crop can be used.")
        if rescale:
            flat = x.reshape((-1, 1) + tuple(x.shape[-2:]))
            out = F.interpolate(flat, size=size, mode="bilinear", align_corners=False,
                                antialias=True).reshape(tuple(x.shape[:-2]) + size)
        elif crop:
            out = MRIMixin.crop_center(x, size)
        else:
            return x
        return out[..., :-1, :] if odd_h else out


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
    :param device: where the mask (and the noise level) live; the CUDA
        device by default.
    """

    def __init__(self, mask=None, img_size=(320, 320), three_d: bool = False, device=None,
                 **kwargs):
        super().__init__(mask=_check_mask(mask, img_size, three_d), **kwargs)
        self.three_d = three_d
        self.to(resolve_device(device))

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


class MultiCoilMRI(MRIMixin, LinearPhysics):
    r"""Multi-coil MRI ``y_n = M F (s_n . x)`` (mri.py:200): measurements
    ``(B, 2, N, H, W)``, coil maps ``s`` complex ``(B, N, H, W)``.

    :param mask: the sampling mask, as for :class:`MRI`; a generator's ``(B,
        C, H, W)`` mask goes through ``update(mask=...)`` as it is, and
        ``A`` takes its channel 0.
    :param coil_maps: complex maps ``(B or 1, N, H, W)``, or an int N for N
        constant maps.
    :param img_size: the image's size (and that of the all-ones mask).
    :param kspace_trajectory: ``(2, M)`` k-space points in radians: the
        non-Cartesian path, the NUFFT of each coil's view (the plan built
        once, on the device).
    :param fast_normal: with a trajectory, ``A_adjoint_A`` through the
        Toeplitz embedding (two FFTs a coil) in place of a NUFFT pair.
    :param device: where the mask, maps and plan live; the CUDA device by
        default.
    """

    def __init__(self, mask=None, coil_maps=1, img_size=(320, 320), three_d: bool = False,
                 kspace_trajectory=None, fast_normal: bool = True, device=None, **kwargs):
        super().__init__(**kwargs)
        self.three_d = three_d
        self.img_size = tuple(img_size)[-2:]
        self.register_buffer("mask", _check_mask(mask, img_size, three_d))
        if isinstance(coil_maps, int):
            coil_maps = torch.ones((1, coil_maps) + tuple(self.mask.shape[-2:]),
                                   dtype=torch.complex64)
        self.register_buffer("coil_maps", torch.as_tensor(coil_maps))
        self.nufft = None
        self.register_buffer("kspace_trajectory", None)
        self.register_buffer("_normal_spec", None)
        if kspace_trajectory is not None:
            traj = torch.as_tensor(kspace_trajectory, dtype=torch.float32)
            self.kspace_trajectory = traj
            self.nufft = NufftPlan(traj.numpy(), self.img_size)
            if fast_normal:
                self._normal_spec = nufft2_toeplitz_spec(traj.numpy(), self.img_size)
        self.to(resolve_device(device))

    @property
    def fast_normal(self) -> bool:
        return self._normal_spec is not None

    @staticmethod
    def check_coil_maps(coil_maps, three_d: bool = False):
        """Coil maps as complex ``(B, N, H, W)`` (``(B, N, D, H, W)`` in 3D)
        (mri.py:241)."""
        coil_maps = torch.as_tensor(coil_maps)
        while coil_maps.dim() < (5 if three_d else 4):
            coil_maps = coil_maps[None]
        if not coil_maps.is_complex():
            raise ValueError("coil_maps should be of complex dtype.")
        return coil_maps

    def update(self, **params):
        """A new physics; a new ``mask`` is normalized as at construction."""
        if params.get("mask") is not None:
            params["mask"] = _check_mask(params["mask"], three_d=self.three_d).to(
                self.mask.device)
        return super().update(**params)

    def _combine(self, imgs, maps):
        """``sum_n conj(s_n) imgs_n`` as a real ``(B, 2, H, W)`` image."""
        out = (maps.conj() * imgs).sum(1, keepdim=True)
        return torch.cat([out.real, out.imag], dim=1)

    def A(self, x, mask=None, coil_maps=None, **params):
        phys = self.update(mask=mask, coil_maps=coil_maps)
        sx = self.to_complex(x) * phys.coil_maps                              # (B, N, H, W)
        if self.nufft is not None:
            yk = self.nufft(sx)                                               # (B, N, M)
        else:
            axes = (-3, -2, -1) if self.three_d else (-2, -1)
            yk = self.fft(sx, axes=axes) * phys.mask[:, 0:1]
        return torch.stack([yk.real, yk.imag], dim=1)

    def A_adjoint(self, y, mask=None, coil_maps=None, rss: bool = False, crop=None, **params):
        """``sum_n conj(s_n) F^H M y_n`` (mri.py:280); ``rss`` gives the
        root-sum-of-squares of the coil images instead, ``crop`` a centre
        crop."""
        phys = self.update(mask=mask, coil_maps=coil_maps)
        yk = torch.complex(y[:, 0], y[:, 1])
        if self.nufft is not None:
            imgs = self.nufft.adjoint(yk)
        else:
            axes = (-3, -2, -1) if self.three_d else (-2, -1)
            imgs = self.ifft(yk * phys.mask[:, 0:1], axes=axes)
        x = (imgs.abs() ** 2).sum(1, keepdim=True).sqrt() if rss else \
            self._combine(imgs, phys.coil_maps)
        if crop is not None and self.nufft is None:
            x = self.crop_center(x, crop)
        return x

    def A_adjoint_A(self, x, **params):
        """``A^H A x``: through the Toeplitz spectrum on the non-Cartesian
        path with ``fast_normal`` (mri.py:251), else ``A_adjoint(A(x))``."""
        if self._normal_spec is None:
            return self.A_adjoint(self.A(x, **params), **params)
        phys = self.update(**params) if params else self
        imgs = nufft2_normal(self.to_complex(x) * phys.coil_maps, self._normal_spec)
        return self._combine(imgs, phys.coil_maps)

    def noise(self, y, generator=None):
        """Noise on the sampled k-space only (mri.py:304); on every sample of
        the non-Cartesian path."""
        if self.noise_model is None:
            return y
        n = self.noise_model(y, generator=generator)
        return n if self.nufft is not None else n * self.mask[:, :, None]

    def simulate_birdcage_csm(self, n_coils: int):
        """Birdcage maps of ``img_size`` (mri.py:315), on the mask's device."""
        return birdcage_maps(n_coils, self.img_size).to(self.mask.device)

    @staticmethod
    def estimate_coil_maps(y, calib_size: int = 24, kernel_size: int = 6, thresh: float = 0.02,
                           espirit_crop: float = 0.95):
        """ESPIRiT coil maps from multi-coil k-space (mri.py:323; Uecker et
        al. 2014): the calibration matrix of ``kernel_size``-square windows
        of the central ``calib_size`` block, its right singular vectors above
        ``thresh`` of the first as image-domain kernels, and at each pixel
        the leading eigenvector of their Gram, aligned in phase to coil 0 and
        zeroed where the eigenvalue is at most ``espirit_crop``.

        The Gram sums over the kernels ``_ESPIRIT_CHUNK`` at a time, so that
        the image-domain kernels ``(R, N, H, W)`` are never held at once (at
        320² with 15 coils they would take 4.4 GB).

        :param y: k-space, complex ``(B, N, H, W)`` or real ``(B, 2, N, H, W)``.
        :return: complex maps ``(B, N, H, W)``.
        """
        if not y.is_complex():
            y = torch.complex(y[:, 0], y[:, 1])
        B, N, H, W = y.shape
        k = kernel_size
        cs = min(calib_size, H, W)
        r0, c0 = (H - k) // 2, (W - k) // 2

        def one(yk):
            calib = yk[:, (H - cs) // 2:(H + cs) // 2, (W - cs) // 2:(W + cs) // 2]
            # the block-Hankel calibration matrix (L, N*k*k), channel-major
            win = calib.unfold(1, k, 1).unfold(2, k, 1)                      # (N, l, l, k, k)
            A = win.permute(1, 2, 0, 3, 4).reshape(-1, N * k * k)
            _, s, vh = torch.linalg.svd(A, full_matrices=False)
            keep = (s > thresh * s[0]).to(yk.real.dtype)
            kernels = vh.reshape(-1, N, k, k).flip(-2, -1)
            gram = torch.zeros((H * W, N, N), dtype=yk.dtype, device=yk.device)
            for lo in range(0, kernels.shape[0], _ESPIRIT_CHUNK):
                ker = kernels[lo:lo + _ESPIRIT_CHUNK]
                pad = torch.zeros(ker.shape[:2] + (H, W), dtype=ker.dtype, device=ker.device)
                pad[..., r0:r0 + k, c0:c0 + k] = ker
                M = torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(pad, dim=(-2, -1))),
                                       dim=(-2, -1)) * (math.sqrt(H * W) / k)
                Mp = (M * keep[lo:lo + _ESPIRIT_CHUNK, None, None, None]).reshape(
                    M.shape[0], N, H * W)
                Mp = Mp.permute(2, 1, 0)                                     # (HW, N, r)
                gram += Mp @ Mp.conj().transpose(1, 2)
            # cuSOLVER's batched eigensolver (torch 2.11, CUDA 12.8, H100)
            # rejects 32768 15x15 matrices a call and takes 4096; a 320²
            # image has 102400 pixels
            lam, v = zip(*(torch.linalg.eigh(gram[p:p + _EIGH_BATCH])
                           for p in range(0, H * W, _EIGH_BATCH)))
            lam, v = torch.cat(lam)[:, -1:], torch.cat(v)[:, :, -1]
            v = v * torch.exp(-1j * torch.angle(v[:, :1]))
            v = v * (lam > espirit_crop)
            return v.T.reshape(N, H, W)

        return torch.stack([one(y[b]) for b in range(B)])


def birdcage_maps(n_coils: int, shape, r: float = 1.5):
    """Birdcage coil sensitivities ``(N, H, W)`` complex64 (mri.py:384):
    coil ``c`` an inverse-distance field from a point on a circle of radius
    ``r`` around the field of view, with a rotating phase, normalised by the
    root-sum-of-squares. Made on the host (CPU tensor)."""
    H, W = shape[-2:]
    c = np.arange(n_coils)
    yy, xx = np.mgrid[0:H, 0:W]
    x_co = (xx - W / 2.0) / W * 2
    y_co = (yy - H / 2.0) / H * 2
    coilx = r * np.cos(c * 2 * np.pi / n_coils)[:, None, None]
    coily = r * np.sin(c * 2 * np.pi / n_coils)[:, None, None]
    coil_phs = (-c * 2 * np.pi / n_coils)[:, None, None]
    rr = np.sqrt((x_co[None] - coilx) ** 2 + (y_co[None] - coily) ** 2)
    phi = np.arctan2(x_co[None] - coilx, -(y_co[None] - coily)) + coil_phs
    out = (1.0 / rr) * np.exp(1j * phi)
    out = out / np.sqrt(np.sum(np.abs(out) ** 2, axis=0))
    return torch.from_numpy(out.astype(np.complex64))


class DynamicMRI(TimeMixin, MRI):
    r"""Dynamic (k-t) MRI (mri.py:402): each frame of ``(B, 2, T, H, W)`` data
    masked in k-space; the mask may vary over time ``(B, 2, T, H, W)``."""

    def __init__(self, mask=None, img_size=(8, 320, 320), **kwargs):
        super().__init__(mask=mask, img_size=img_size, three_d=False, **kwargs)

    def to_static(self, mask=None) -> MRI:
        """A static :class:`MRI` (mri.py:418) with ``mask``, or with the union
        of the frames' masks."""
        if mask is None:
            mask = self.mask.sum(-3).clamp(0.0, 1.0)
        return MRI(mask=mask, img_size=tuple(mask.shape[-2:]), noise_model=self.noise_model,
                   device=mask.device)


class SequentialMRI(DynamicMRI):
    r"""Sequential sampling (mri.py:429): masks that vary over time and whose
    union makes one static image."""

    def average(self, y, mask=None):
        """The frames' sum over the number of frames sampled at each point
        (mri.py:433); time is axis -3 of the measurements and of the mask."""
        m = self.mask if mask is None else mask
        return y.sum(-3) / m.sum(-3).clamp_min(1e-6)

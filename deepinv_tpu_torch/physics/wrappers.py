"""Physics wrappers: multiscale and cropping (port of
deepinv_tpu/physics/wrappers.py).

The multiscale wrappers evaluate a base physics from a coarse image,
``A_s(x_s) = A(U_s x_s)``, with ``U_s`` a sinc-filtered zero-fill
upsampling (an :class:`Upsampling`). ``scale`` may be passed to every
method; ``set_scale`` keeps the reference's mutating setter.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import LinearPhysics, Physics, replace
from .blur import Blur, BlurFFT, Upsampling

__all__ = ["PhysicsMultiScaler", "LinearPhysicsMultiScaler", "BlurMultiScaler",
           "BlurFFTMultiScaler", "InpaintingMultiScaler", "coarse_blur_filter",
           "PhysicsCropper", "to_multiscale", "VirtualLinearPhysics"]


def _sync_noise(old, new, params):
    """``new`` with its own noise model set to its base's where the update
    replaced the base's (wrappers.py:100-106): the wrapper's ``forward``
    draws from its own."""
    nm = getattr(new.base, "noise_model", None)
    if "noise_model" in params or nm is not getattr(old.base, "noise_model", None):
        new = replace(new, noise_model=nm)
    return new


class PhysicsMultiScaler(Physics):
    r"""A physics evaluated from coarse scales (wrappers.py:39):
    ``A_s(x_s) = A(U_s x_s)``, ``U_s`` the upsampling by ``factors[s - 1]``
    with an anti-aliasing filter (sinc by default); scale 0 is the base.

    :param physics: the base physics at the fine scale.
    :param img_size: the fine image's ``(C, H, W)``.
    :param device: where the upsamplings' filters live; the CUDA device by
        default.
    """

    def __init__(self, physics: Physics, img_size=None, filter="sinc", factors=(2, 4, 8),
                 scale: int = 0, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        self.base = physics
        self.img_size = tuple(img_size) if img_size is not None else None
        self.factors = tuple(factors)
        self.upsamplings = nn.ModuleList([
            Upsampling(img_size=self.img_size, filter=filter, factor=f, device=device)
            for f in self.factors])
        self.scale = scale
        self.noise_model = physics.noise_model
        self.sensor_model = physics.sensor_model

    def set_scale(self, scale=None):
        """The reference's mutating scale setter (wrappers.py:62)."""
        if scale is not None:
            self.scale = scale

    def with_scale(self, scale: int):
        return replace(self, scale=scale)

    def _s(self, scale):
        return self.scale if scale is None else scale

    def A(self, x, scale=None, **params):
        s = self._s(scale)
        return self.base.A(x if s == 0 else self.upsamplings[s - 1].A(x), **params)

    def upsample(self, x, scale=None):
        s = self._s(scale)
        return x if s == 0 else self.upsamplings[s - 1].A(x)

    def downsample(self, x, scale=None):
        s = self._s(scale)
        return x if s == 0 else self.upsamplings[s - 1].A_adjoint(x)

    def downsample_measurement(self, y, scale=None):
        raise NotImplementedError(
            "downsample_measurement is physics-specific; see BlurMultiScaler, "
            "BlurFFTMultiScaler, InpaintingMultiScaler (wrappers.py:87).")

    def update(self, **params):
        return _sync_noise(self, replace(self, base=self.base.update(**params)), params)


class LinearPhysicsMultiScaler(PhysicsMultiScaler, LinearPhysics):
    r"""The linear multiscale wrapper (wrappers.py:109): ``A_s^T = U_s^T A^T``;
    a coarse scale's ``A_dagger`` and ``prox_l2`` are the Krylov ones."""

    def A_adjoint(self, y, scale=None, **params):
        s = self._s(scale)
        at = self.base.A_adjoint(y, **params)
        return at if s == 0 else self.upsamplings[s - 1].A_adjoint(at)

    def A_adjoint_A(self, x, scale=None, **params):
        return self.A_adjoint(self.A(x, scale=scale, **params), scale=scale, **params)

    def A_dagger(self, y, scale=None, **params):
        s = self._s(scale)
        if s == 0:
            return self.base.A_dagger(y, **params)
        return LinearPhysics.A_dagger(self.with_scale(s), y, **params)

    def prox_l2(self, z, y, gamma, scale=None, **params):
        s = self._s(scale)
        if s == 0:
            return self.base.prox_l2(z, y, gamma, **params)
        return LinearPhysics.prox_l2(self.with_scale(s), z, y, gamma, **params)


def coarse_blur_filter(in_filter, downsampling_filter, scale: int = 2) -> torch.Tensor:
    r"""The coarse-scale operator's blur filter (wrappers.py:134): the fine
    filter convolved with the anti-aliasing filter and decimated, its mass
    kept."""
    in_filter = torch.as_tensor(in_filter, dtype=torch.float32)
    df = torch.as_tensor(downsampling_filter, dtype=torch.float32).to(in_filter.device)
    diff_h = max(df.shape[-2] - in_filter.shape[-2], 0)
    diff_w = max(df.shape[-1] - in_filter.shape[-1], 0)
    pad_left, pad_top = diff_w // 2, diff_h // 2
    new_filt = F.pad(in_filter, (pad_left, diff_w - pad_left, pad_top, diff_h - pad_top))
    # pad so that the strided 'valid' convolution covers the whole support
    ph, pw = df.shape[-2] // 2, df.shape[-1] // 2
    new_filt = F.pad(new_filt, (pw, pw, ph, ph))
    B, C, H, W = new_filt.shape
    ker = df[:1, :1].reshape((1, 1) + df.shape[-2:])
    out = F.conv2d(new_filt.reshape(B * C, 1, H, W), ker, stride=scale)
    coarse = out.reshape(B, C, out.shape[-2], out.shape[-1])
    return coarse / coarse.sum() * new_filt.sum()


class _CoarseMultiScaler(LinearPhysicsMultiScaler):
    """A multiscale wrapper whose coarse scales hold an operator of their own
    (``scaled_physics``, made by :meth:`_coarse`), so that a coarse
    ``A_adjoint_A`` runs on the coarse grid (wrappers.py:164-249)."""

    def __init__(self, physics, img_size=None, filter="sinc", factors=(2, 4, 8), device=None,
                 **kwargs):
        device = resolve_device(device)
        super().__init__(physics, img_size=img_size, filter=filter, factors=factors,
                         device=device, **kwargs)
        self.scaled_physics = nn.ModuleList(self._coarse(physics, device))

    def _coarse(self, physics, device) -> list:
        raise NotImplementedError

    def downsample_measurement(self, y, scale=None):
        s = self._s(scale)
        return y if s == 0 else self.upsamplings[s - 1].A_adjoint(y)

    def A_adjoint_A(self, x, scale=None, **params):
        s = self._s(scale)
        if s == 0:
            return self.base.A_adjoint_A(x, **params)
        return self.scaled_physics[s - 1].A_adjoint_A(x) / self.factors[s - 1] ** 2


class BlurMultiScaler(_CoarseMultiScaler):
    r"""Multiscale blur (wrappers.py:164): each coarse scale a :class:`Blur`
    with the pre-coarsened filter."""

    def _coarse(self, physics, device) -> list:
        return [Blur(filter=coarse_blur_filter(physics.filter, ups.filter, ups.factor),
                     padding=physics.padding, device=device) for ups in self.upsamplings]


class BlurFFTMultiScaler(_CoarseMultiScaler):
    r"""Multiscale FFT blur (wrappers.py:194): each coarse scale a
    :class:`BlurFFT` on the coarse grid."""

    def _coarse(self, physics, device) -> list:
        C, H, W = self.img_size if self.img_size is not None else physics.img_size
        return [BlurFFT(img_size=(C, math.ceil(H / ups.factor), math.ceil(W / ups.factor)),
                        filter=coarse_blur_filter(physics.filter, ups.filter, ups.factor),
                        device=device) for ups in self.upsamplings]


class InpaintingMultiScaler(_CoarseMultiScaler):
    r"""Multiscale inpainting (wrappers.py:223): each coarse scale an
    :class:`Inpainting` whose mask is the sinc-downsampled fine mask."""

    def _coarse(self, physics, device) -> list:
        from .inpainting import Inpainting

        mask = physics.mask
        out = []
        for ups in self.upsamplings:
            c = ups.A_adjoint(mask[None] if mask.dim() == 3 else mask)
            out.append(Inpainting(img_size=c.shape[-3:], mask=c[0] if mask.dim() == 3 else c,
                                  device=device))
        return out


def to_multiscale(physics: Physics, img_size=None, factors=(2, 4, 8),
                  **kwargs) -> PhysicsMultiScaler:
    """``physics`` wrapped for multiscale evaluation by its specialised
    wrapper where one exists (wrappers.py:250)."""
    from .inpainting import Inpainting

    for cls, wrapper in ((BlurFFT, BlurFFTMultiScaler), (Blur, BlurMultiScaler),
                         (Inpainting, InpaintingMultiScaler),
                         (LinearPhysics, LinearPhysicsMultiScaler)):
        if isinstance(physics, cls):
            return wrapper(physics, img_size=img_size, factors=factors, **kwargs)
    return PhysicsMultiScaler(physics, img_size=img_size, factors=factors, **kwargs)


class PhysicsCropper(LinearPhysics):
    r"""A physics on a padded domain (wrappers.py:279): ``A_pad(x) =
    A(remove_pad(x))``, ``remove_pad`` dropping ``crop`` rows and columns at
    the top and left; ``pad`` (the adjoint) puts zeros back. ``crop`` is
    ``(pad_h, pad_w)`` or ``(pad_c, pad_h, pad_w)``."""

    def __init__(self, physics: LinearPhysics, crop, **kwargs):
        super().__init__(**kwargs)
        self.base = physics
        self.crop = tuple(crop)
        if len(self.crop) not in (2, 3):
            raise ValueError("Crop must be a tuple of length 2 or 3.")
        self.noise_model = physics.noise_model

    def remove_pad(self, x):
        if len(self.crop) == 2:
            return x[..., self.crop[0]:, self.crop[1]:]
        return x[..., self.crop[0]:, self.crop[1]:, self.crop[2]:]

    def pad(self, x):
        pads = []
        for c in reversed(self.crop):
            pads += [c, 0]
        return F.pad(x, pads)

    def A(self, x, **params):
        return self.base.A(self.remove_pad(x), **params)

    def A_adjoint(self, y, **params):
        return self.pad(self.base.A_adjoint(y, **params))

    def update(self, **params):
        return _sync_noise(self, replace(self, base=self.base.update(**params)), params)


class VirtualLinearPhysics(LinearPhysics):
    r"""A physics rebuilt from ``factory`` at each call (wrappers.py:318),
    to hold no operator between calls."""

    def __init__(self, factory: Callable[[], LinearPhysics], **kwargs):
        super().__init__(**kwargs)
        self.factory = factory

    def A(self, x, **params):
        return self.factory().A(x, **params)

    def A_adjoint(self, y, **params):
        return self.factory().A_adjoint(y, **params)

    def A_dagger(self, y, **params):
        return self.factory().A_dagger(y, **params)

    def prox_l2(self, z, y, gamma, **params):
        return self.factory().prox_l2(z, y, gamma, **params)

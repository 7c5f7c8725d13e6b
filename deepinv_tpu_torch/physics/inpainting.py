"""Inpainting and demosaicing (port of deepinv_tpu/physics/inpainting.py).

A :class:`~deepinv_tpu_torch.physics.base.DecomposablePhysics` whose mask is
the singular-value diagonal: closed-form ``prox_l2`` and ``A_dagger``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .base import DecomposablePhysics

__all__ = ["Inpainting", "Demosaicing"]


class Inpainting(DecomposablePhysics):
    r"""Mask-multiplication forward operator (inpainting.py:20).

    :param img_size: image size ``(C, H, W)``.
    :param mask: a float in (0, 1], the probability that a pixel is kept,
        drawn once here from ``generator`` (a CPU ``torch.Generator``; seeded
        from ``seed`` if None), or a tensor / array mask of ``img_size`` (or
        with a leading batch dimension). ``None`` means 0.5.
    :param pixelwise: one draw per pixel shared by the channels.
    :param device: where the mask lives; the CUDA device by default.
    """

    def __init__(self, img_size, mask=None, pixelwise: bool = True, generator=None,
                 seed: int = 0, device=None, **kwargs):
        device = resolve_device(device)
        self.img_size = tuple(img_size)
        if mask is None:
            mask = 0.5
        if isinstance(mask, float) and 0 < mask <= 1:
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            shape = (1,) + self.img_size[1:] if pixelwise else self.img_size
            m = (torch.rand(shape, generator=generator) < mask).float()
            m = m.expand(self.img_size)[None].contiguous()
        else:
            m = torch.as_tensor(mask)
            if m.dim() == len(self.img_size):
                m = m[None]
        super().__init__(mask=m.to(device), **kwargs)

    def noise(self, y, generator=None):
        """Noise on the kept pixels only: measurements outside the mask stay
        exactly zero (inpainting.py:51)."""
        if self.noise_model is None:
            return y
        return self.noise_model(y, generator=generator) * (self.mask.abs() > 0)


class Demosaicing(Inpainting):
    r"""Bayer-pattern demosaicing (inpainting.py:63): the RGGB mask keeps one
    colour a pixel.

    :param img_size: ``(3, H, W)`` or ``(H, W)``.
    :param pattern: ``"RGGB"``, the one pattern of the JAX package.
    :param device: where the mask lives; the CUDA device by default.
    """

    def __init__(self, img_size, pattern: str = "RGGB", device=None, **kwargs):
        _, H, W = img_size if len(img_size) == 3 else (3,) + tuple(img_size)
        if pattern.upper() != "RGGB":
            raise ValueError(f"unsupported Bayer pattern {pattern!r}")
        mask = np.zeros((3, H, W), np.float32)
        mask[0, 0::2, 0::2] = 1   # R
        mask[1, 0::2, 1::2] = 1   # G
        mask[1, 1::2, 0::2] = 1   # G
        mask[2, 1::2, 1::2] = 1   # B
        super().__init__((3, H, W), mask=torch.from_numpy(mask), device=device, **kwargs)

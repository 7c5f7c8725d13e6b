"""Remote sensing (port of deepinv_tpu/physics/remote_sensing.py):
pansharpening as the stack of a :class:`Downsampling` (the low-resolution
multispectral image) and a :class:`Decolorize` (the high-resolution
panchromatic one); the measurement is the TensorList ``[color_lr, pan_hr]``.
"""

from __future__ import annotations

from ..device import resolve_device
from .base import StackedLinearPhysics
from .blur import Downsampling
from .misc import Decolorize

__all__ = ["Pansharpen"]


class Pansharpen(StackedLinearPhysics):
    r"""Pansharpening (remote_sensing.py:19).

    :param img_size: ``(C, H, W)`` of the high-resolution multispectral image.
    :param filter: the downsampling branch's anti-aliasing filter.
    :param factor: the downsampling factor.
    :param srf: the panchromatic branch's spectral response.
    :param noise_color: the low-resolution branch's noise model.
    :param noise_gray: the panchromatic branch's noise model.
    :param device: where the filters live; the CUDA device by default.
    """

    def __init__(self, img_size, filter="gaussian", factor: int = 4, srf="flat",
                 noise_color=None, noise_gray=None, padding: str = "circular", device=None,
                 **kwargs):
        device = resolve_device(device)
        downsampling = Downsampling(img_size=img_size, filter=filter, factor=factor,
                                    padding=padding, noise_model=noise_color, device=device)
        decolorize = Decolorize(img_size=img_size, srf=srf, noise_model=noise_gray,
                                device=device)
        super().__init__([downsampling, decolorize], **kwargs)
        self.img_size = tuple(img_size)
        self.factor = factor

    @property
    def downsampling(self):
        return self.physics_list[0]

    @property
    def decolorize(self):
        return self.physics_list[1]

    def brovey(self, y, eps: float = 1e-6):
        """The Brovey pansharpening baseline (remote_sensing.py:55)."""
        color_lr, pan = y[0], y[1]
        up = self.downsampling.A_adjoint(color_lr) * (self.factor ** 2)
        return up * pan / up.mean(dim=1, keepdim=True).clamp_min(eps)

"""Rotation (port of the exact rot90 subgroup of
deepinv_tpu/transform/geometric.py's ``Rotate``; its bilinear warp for other
angles waits, ROADMAP queue 1) and the exact three-shear rotation
:func:`rotate_via_shear` (geometric.py:185)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .base import Transform

__all__ = ["Rotate", "rotate_via_shear"]


def rotate_via_shear(image, angle):
    r"""Rotate ``(B, C, H, W)`` square images by ``angle`` degrees (a scalar
    or ``(B,)``), counter-clockwise, by three FFT shears
    ``Shear_u(a) Shear_v(b) Shear_u(a)`` with ``a = -tan(theta/2)``, ``b =
    sin(theta)`` (geometric.py:185): the angle is reduced to [-45, 45]
    degrees by an exact ``rot90`` and the shears run on a grid of twice the
    size."""
    from ..ops.radon_fourier import _fft_shear, _next_smooth

    B, C, H, W = image.shape
    if H != W:
        raise ValueError("rotate_via_shear needs square images")
    th = torch.deg2rad(torch.as_tensor(angle, dtype=torch.float32,
                                       device=image.device).broadcast_to((B,)))
    k = torch.round(th / (math.pi / 2)).long()
    th_r = th - k.float() * (math.pi / 2)
    rots = torch.stack([torch.rot90(image, i, dims=(-2, -1)) for i in range(4)], 1)
    base = rots[torch.arange(B, device=image.device), torch.remainder(k, 4)]
    G = _next_smooth(2 * W)
    before = (G - W) // 2
    c = before + (W - 1) / 2.0
    emb = F.pad(base, (before, G - W - before, before, G - W - before))
    t = (-th_r).repeat_interleave(C)
    a, b = -torch.tan(t / 2.0), torch.sin(t)
    freqs = torch.fft.fftfreq(G, device=image.device)
    other = torch.arange(G, device=image.device) - c
    st = emb.reshape(B * C, G, G).to(torch.complex64)
    st = _fft_shear(st, a, freqs, other, -2)
    st = _fft_shear(st, b, freqs, other, -1)
    st = _fft_shear(st, a, freqs, other, -2)
    return st.real.reshape(B, C, G, G)[:, :, before:before + H, before:before + W]


class Rotate(Transform):
    """Rotation by multiples of ``multiples`` degrees (geometric.py:76). Only
    the exact subgroup (``multiples`` and ``limits`` multiples of 90) is
    ported: each sample is rotated by ``torch.rot90`` (``jnp.rot90``'s
    direction)."""

    def __init__(self, multiples: float = 90.0, limits: float = 360.0, n_trans: int = 1,
                 seed: int = 0):
        super().__init__(n_trans, seed)
        if multiples % 90 or limits % 90:
            raise NotImplementedError("Rotate by angles other than multiples of 90 degrees "
                                      "(the bilinear warp) waits for ROADMAP queue 1")
        self.multiples = multiples
        self.limits = limits

    def get_params(self, x, generator=None):
        """``theta`` in degrees, one per output sample (geometric.py:99)."""
        n = self.n_trans * x.shape[0]
        n_angles = max(int(self.limits / self.multiples), 1)
        device = generator.device if generator is not None else x.device
        idx = torch.randint(0, n_angles, (n,), generator=generator, device=device)
        return {"theta": idx.to(x.device, torch.float32) * self.multiples}

    def transform(self, x, theta=None):
        x = self._repeat(x) if x.shape[0] != theta.shape[0] else x
        k = (theta / 90.0).long() % 4
        rots = torch.stack([torch.rot90(x, i, dims=(-2, -1)) for i in range(4)], 1)
        return rots[torch.arange(x.shape[0], device=x.device), k]

"""Shift, Rotate, Scale and Reflect (port of
deepinv_tpu/transform/geometric.py), the bilinear warp they share
(:func:`map_coordinates`, :func:`_warp_affine`) and the exact three-shear
rotation :func:`rotate_via_shear` (geometric.py:185).

The JAX package warps with ``jax.scipy.ndimage.map_coordinates`` (order 0
or 1); :func:`map_coordinates` writes the same sum out: each of the 2^d
corners of a sample point weighted by the product of its 1-D weights, in
JAX's order, with JAX's index fixers for the border modes. In ``constant``
mode a corner outside the image adds nothing and a corner inside keeps its
weight, so a point half outside takes its in-image neighbour's share
(``grid_sample(align_corners=True, padding_mode="zeros")`` does the same,
up to the rounding of its normalised coordinates).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .base import Transform, _device

__all__ = ["Shift", "Rotate", "Scale", "Reflect", "rotate_via_shear", "map_coordinates"]


def _round_half_away(c):
    return torch.sign(c) * torch.floor(torch.abs(c) + 0.5)


def _fix_index(index, size: int, mode: str):
    """JAX's index fixers for the warps' border modes
    (``jax/_src/scipy/ndimage.py`` ``_INDEX_FIXERS``)."""
    if mode == "constant":
        return index
    if mode == "nearest":
        return index.clamp(0, size - 1)
    if mode == "reflect":  # JAX's mirror index of 2 i + 1 over 2 n + 1, halved
        s = 2 * size
        return torch.div(torch.abs(torch.remainder(2 * index + 1 + s, 2 * s) - s) - 1, 2,
                         rounding_mode="floor")
    raise NotImplementedError(f"map_coordinates mode {mode!r}")


def map_coordinates(img, rows, cols, order: int = 1, mode: str = "constant"):
    """Sample ``img`` (``(..., H, W)``) at the points ``(rows, cols)``
    (each of shape ``(..., P)`` or broadcastable to the leading dims), as
    ``jax.scipy.ndimage.map_coordinates(order, mode, cval=0)`` per plane.
    Returns ``(..., P)``.

    :param order: 0 (nearest, halves rounded away from zero) or 1
        (bilinear).
    :param mode: ``constant`` (0 outside), ``nearest`` or ``reflect``.
    """
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.reshape(lead + (H * W,))
    rows = rows.to(img.dtype if img.is_floating_point() else torch.float32)
    cols = cols.to(rows.dtype)

    def nodes(c):
        if order == 0:
            return [(_round_half_away(c).long(), torch.ones((), dtype=c.dtype, device=c.device))]
        if order != 1:
            raise NotImplementedError("map_coordinates takes order 0 or 1")
        lower = torch.floor(c)
        upper_w = c - lower
        idx = lower.long()
        return [(idx, 1 - upper_w), (idx + 1, upper_w)]

    out = None
    for ri, rw in nodes(rows):
        rv = (ri >= 0) & (ri < H)
        rf = _fix_index(ri, H, mode).clamp(0, H - 1)
        for ci, cw in nodes(cols):
            cf = _fix_index(ci, W, mode).clamp(0, W - 1)
            idx = (rf * W + cf).broadcast_to(lead + rf.shape[-1:])
            v = torch.gather(flat, -1, idx)
            if mode == "constant":
                valid = rv & (ci >= 0) & (ci < W)
                v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))
            term = (rw * cw) * v
            out = term if out is None else out + term
    return out


def _warp_affine(x, mat):
    """Warp ``(B, C, H, W)`` by ``mat`` (``(B, 2, 3)``), which maps centred
    output coordinates (row, col) to centred input coordinates; bilinear, 0
    outside (geometric.py:23)."""
    B, C, H, W = x.shape
    dev = x.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    coords = torch.stack([yy - cy, xx - cx], 0).reshape(2, -1).to(torch.float32)
    mat = mat.to(device=dev, dtype=torch.float32)
    src = mat[:, :, :2] @ coords + mat[:, :, 2:3]
    rows = (src[:, 0] + cy)[:, None]
    cols = (src[:, 1] + cx)[:, None]
    return map_coordinates(x, rows, cols, 1, "constant").reshape(B, C, H, W)


class Shift(Transform):
    """Cyclic pixel shift (geometric.py:47): integer shifts drawn on
    ``[-int(shift_max H), int(shift_max H))`` per output sample."""

    def __init__(self, shift_max: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.shift_max = shift_max

    def get_params(self, x, generator=None):
        """``y_shift`` then ``x_shift`` (geometric.py:54)."""
        H, W = x.shape[-2:]
        n = self.n_trans * x.shape[0]
        dev = _device(x, generator)
        ah, aw = int(self.shift_max * H), int(self.shift_max * W)
        sy = torch.randint(-ah, max(ah, 1), (n,), generator=generator, device=dev)
        sx = torch.randint(-aw, max(aw, 1), (n,), generator=generator, device=dev)
        return {"y_shift": sy.to(x.device), "x_shift": sx.to(x.device)}

    def transform(self, x, y_shift=None, x_shift=None):
        x = self._repeat(x) if x.shape[0] != y_shift.shape[0] else x
        H, W = x.shape[-2:]
        dev = x.device
        rows = torch.remainder(torch.arange(H, device=dev)[None] - y_shift.to(dev).long()[:, None], H)
        cols = torch.remainder(torch.arange(W, device=dev)[None] - x_shift.to(dev).long()[:, None], W)
        shape = (x.shape[0],) + (1,) * (x.dim() - 3)
        x = torch.gather(x, -2, rows.reshape(shape + (H, 1)).expand(x.shape))
        return torch.gather(x, -1, cols.reshape(shape + (1, W)).expand(x.shape))


class Rotate(Transform):
    """Rotation by a multiple of ``multiples`` degrees below ``limits``
    (geometric.py:76). Where both are multiples of 90 the exact ``rot90``
    subgroup is used (``jnp.rot90``'s direction); any other angle warps
    bilinearly about the image centre, 0 outside (:func:`_warp_affine`).
    ``interpolation`` is the warp's: only ``"bilinear"`` is implemented, and
    another raises where the warp runs (the JAX package warps bilinearly
    whatever it is given, geometric.py:93, 118)."""

    def __init__(self, multiples: float = 90.0, limits: float = 360.0,
                 interpolation: str = "bilinear", n_trans: int = 1, seed: int = 0):
        super().__init__(n_trans, seed)
        self.multiples = multiples
        self.limits = limits
        self.interpolation = interpolation

    def get_params(self, x, generator=None):
        """``theta`` in degrees, one per output sample (geometric.py:99)."""
        n = self.n_trans * x.shape[0]
        n_angles = max(int(self.limits / self.multiples), 1)
        idx = torch.randint(0, n_angles, (n,), generator=generator, device=_device(x, generator))
        return {"theta": idx.to(x.device, torch.float32) * self.multiples}

    def transform(self, x, theta=None):
        theta = torch.as_tensor(theta, dtype=torch.float32, device=x.device).reshape(-1)
        x = self._repeat(x) if x.shape[0] != theta.shape[0] else x
        if self.multiples % 90 == 0 and self.limits % 90 == 0:
            k = (theta / 90.0).long() % 4
            rots = torch.stack([torch.rot90(x, i, dims=(-2, -1)) for i in range(4)], 1)
            return rots[torch.arange(x.shape[0], device=x.device), k]
        if self.interpolation != "bilinear":
            raise NotImplementedError(f"Rotate warps bilinearly only, not {self.interpolation!r}")
        th = torch.deg2rad(theta)
        c, s = torch.cos(th), torch.sin(th)
        z = torch.zeros_like(c)
        mat = torch.stack([torch.stack([c, s, z], -1), torch.stack([-s, c, z], -1)], -2)
        return _warp_affine(x, mat)


class Scale(Transform):
    """Isotropic dilation about the centre by a factor drawn from
    ``factors`` (geometric.py:123); inverted by the reciprocal."""

    def __init__(self, factors=(0.75, 0.5), **kwargs):
        super().__init__(**kwargs)
        self.factors = tuple(factors)

    def get_params(self, x, generator=None):
        n = self.n_trans * x.shape[0]
        idx = torch.randint(0, len(self.factors), (n,), generator=generator,
                            device=_device(x, generator))
        return {"factor": torch.tensor(self.factors, dtype=torch.float32)[idx.cpu()].to(x.device)}

    def invert_params(self, params):
        return {"factor": 1.0 / params["factor"]}

    def transform(self, x, factor=None):
        factor = torch.as_tensor(factor, dtype=torch.float32, device=x.device).reshape(-1)
        x = self._repeat(x) if x.shape[0] != factor.shape[0] else x
        z = torch.zeros_like(factor)
        mat = torch.stack([torch.stack([1.0 / factor, z, z], -1),
                           torch.stack([z, 1.0 / factor, z], -1)], -2)
        return _warp_affine(x, mat)


class Reflect(Transform):
    """Random flips of the axes ``dim`` (geometric.py:153); an involution."""

    def __init__(self, dim=(-1,), **kwargs):
        super().__init__(**kwargs)
        self.dim = tuple(dim)

    def get_params(self, x, generator=None):
        n = self.n_trans * x.shape[0]
        flips = torch.rand((n, len(self.dim)), generator=generator,
                           device=_device(x, generator)) < 0.5
        return {"flip": flips.to(x.device, torch.float32)}

    def invert_params(self, params):
        return params

    def transform(self, x, flip=None):
        flip = torch.as_tensor(flip, device=x.device)
        x = self._repeat(x) if x.shape[0] != flip.shape[0] else x
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        out = x
        for i, ax in enumerate(self.dim):
            out = torch.where(flip[:, i].reshape(shape) > 0.5, torch.flip(out, (ax,)), out)
        return out


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

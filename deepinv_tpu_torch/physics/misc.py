"""Miscellaneous operators (port of deepinv_tpu/physics/misc.py): haze,
single-photon lidar, decolorization, phase wrapping, hyperspectral unmixing
and the CASSI spectral camera.

The unmixing products run in exact f32
(:func:`~deepinv_tpu_torch.core.exact_f32`). Random tables (the unmixing
matrix, the coded aperture) are drawn on the CPU from the caller's
``torch.Generator`` and moved, or taken from the caller.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import TensorList
from ..core.linalg import exact_f32
from ..device import resolve_device
from .base import DecomposablePhysics, LinearPhysics, Physics

__all__ = ["Haze", "SinglePhotonLidar", "Decolorize", "SpatialUnwrapping",
           "HyperSpectralUnmixing", "CompressiveSpectralImaging"]


class Haze(Physics):
    r"""Koschmieder's haze model (misc.py:25): ``y = t I + a (1 - t)`` with
    the transmission ``t = exp(-beta (d + offset))``; the input is the
    TensorList ``[image, depth, airlight]``."""

    def __init__(self, beta: float = 0.1, offset: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.beta = beta
        self.offset = offset

    def A(self, x, **params):
        im, d, A0 = x[0], x[1], x[2]
        t = torch.exp(-self.beta * (d + self.offset))
        return t * im + A0 * (1 - t)

    def A_dagger(self, y, **params):
        """A dark-channel-prior inversion with the global maximum as the
        airlight (misc.py:41)."""
        A0 = y.amax(dim=(-2, -1), keepdim=True)
        dark = (y / A0.clamp_min(1e-6)).amin(dim=1, keepdim=True)
        t = (1.0 - dark).clamp(0.1, 1.0)
        im = (y - A0 * (1 - t)) / t
        d = -torch.log(t.clamp_min(1e-6)) / self.beta
        return TensorList([im, d, A0])


class SinglePhotonLidar(Physics):
    r"""Single-photon lidar (misc.py:53): a temporal histogram a pixel,
    ``y[t] = r g(t - d) + b`` with a Gaussian pulse ``g``; ``x`` is ``(B, 3,
    H, W)`` (depth, reflectivity, background), ``y`` ``(B, bins, H, W)``."""

    def __init__(self, sigma: float = 1.0, bins: int = 50, **kwargs):
        super().__init__(**kwargs)
        self.sigma = sigma
        self.bins = bins

    def _t(self, like):
        return torch.arange(self.bins, dtype=like.dtype, device=like.device).reshape(
            1, self.bins, 1, 1)

    def A(self, x, **params):
        d, r, b = x[:, 0:1], x[:, 1:2], x[:, 2:3]
        pulse = torch.exp(-((self._t(x) - d) ** 2) / (2 * self.sigma ** 2))
        return r * pulse / (math.sqrt(2 * math.pi) * self.sigma) + b

    def A_dagger(self, y, **params):
        """Matched-filter depth and moment estimates (misc.py:76); the median
        of an even number of bins is the mean of the middle two, as
        ``jnp.median`` takes it."""
        s = y.sort(dim=1).values
        b = 0.5 * (s[:, (self.bins - 1) // 2] + s[:, self.bins // 2])[:, None]
        yc = (y - b).clamp_min(0.0)
        r = yc.sum(dim=1, keepdim=True)
        d = (yc * self._t(y)).sum(dim=1, keepdim=True) / r.clamp_min(1e-6)
        return torch.cat([d, r, b], dim=1)


class Decolorize(DecomposablePhysics):
    r"""RGB to grey by a spectral response function (misc.py:86):
    ``A x = sum_c srf_c x_c``; ``srf`` ``"rec601"``, ``"flat"`` or three
    weights.

    :param device: where the response lives; the CUDA device by default.
    """

    def __init__(self, img_size=None, srf="rec601", device=None, **kwargs):
        device = resolve_device(device)
        if isinstance(srf, str) and srf == "rec601":
            w = np.array([0.2989, 0.587, 0.114], np.float32)
        elif isinstance(srf, str) and srf == "flat":
            w = np.ones(3, np.float32) / 3
        elif isinstance(srf, (tuple, list, np.ndarray, torch.Tensor)):
            w = np.asarray(srf, np.float32)
        else:
            raise ValueError(f"unknown srf {srf!r}")
        norm = float(np.linalg.norm(w))
        super().__init__(mask=norm, **kwargs)
        self.register_buffer("srf", torch.from_numpy(w / norm))
        self.to(device)

    def V_adjoint(self, x):
        return (x * self.srf[None, :, None, None]).sum(dim=1, keepdim=True)

    def V(self, y):
        return y * self.srf[None, :, None, None]

    def prox_l2(self, z, y, gamma, **kwargs):
        """``argmin_x gamma/2 ||Ax - y||^2 + 1/2 ||x - z||^2`` in closed form:
        ``A^T A = m^2 V V^T`` is ``m^2`` times the projection on the unit
        ``srf``, so ``(gamma A^T A + I)^-1 b = b - gamma m^2 / (1 + gamma
        m^2) V V^T b``. :class:`DecomposablePhysics`'s closed form, which the
        JAX package takes here (misc.py:86), assumes a square orthogonal
        ``V`` and drops the channel directions ``srf`` does not span
        (ROADMAP Queue 3)."""
        if z is None or isinstance(z, (int, float)):
            z = torch.full_like(self.A_adjoint(y), 0.0 if z is None else float(z))
        g = torch.as_tensor(gamma, dtype=z.dtype, device=z.device)
        g = g.reshape(g.shape + (1,) * (z.dim() - g.dim())) if g.dim() else g
        b = g * self.A_adjoint(y) + z
        gm2 = g * self.mask ** 2
        return b - gm2 / (1 + gm2) * self.V(self.V_adjoint(b))


class SpatialUnwrapping(Physics):
    r"""Phase wrapping ``y = mod(x, threshold)`` (misc.py:111), or the
    symmetric wrap to ``[-t/2, t/2)`` for ``mode="round"``; the noise is
    added before the wrap. ``A_dagger`` integrates the wrapped differences
    (Itoh)."""

    def __init__(self, threshold: float = 2 * math.pi, mode: str = "floor", **kwargs):
        super().__init__(**kwargs)
        if mode not in ("floor", "round"):
            raise ValueError("mode must be 'floor' or 'round'")
        self.threshold = threshold
        self.mode = mode

    def A(self, x, **params):
        t = self.threshold
        if self.mode == "round":
            return x - t * torch.round(x / t)
        return torch.remainder(x, t)

    def forward(self, x, generator=None, **params):
        """The wrap after the noise (misc.py:127)."""
        return self.sensor(self.A(self.noise(x, generator=generator), **params))

    def _wrap(self, v):
        t = self.threshold
        return torch.remainder(v + t / 2, t) - t / 2

    def A_adjoint(self, y, **params):
        """The identity (misc.py:135), so wrapped data can seed a
        reconstruction."""
        return y

    def A_dagger(self, y, **params):
        """Itoh's method: the cumulative sum of the wrapped differences down
        the first column, then along the rows (misc.py:142)."""
        dy = self._wrap(torch.diff(y, dim=-2))
        dx = self._wrap(torch.diff(y, dim=-1))
        col0 = torch.cumsum(torch.cat([y[..., :1, :1], dy[..., :, :1]], dim=-2), dim=-2)
        return torch.cumsum(torch.cat([col0, dx], dim=-1), dim=-1)


class HyperSpectralUnmixing(LinearPhysics):
    r"""Linear unmixing ``y = M^T x`` over E endmembers (misc.py:156): ``x``
    ``(B, E, H, W)`` abundances, ``y`` ``(B, C, H, W)``.

    :param M: the ``(E, C)`` mixing matrix; uniform on [0, 1) from
        ``generator`` (seeded from ``seed`` if None) where None.
    :param device: where ``M`` lives; the CUDA device by default.
    """

    def __init__(self, M=None, E: int = 4, C: int = 8, generator=None, seed: int = 0,
                 device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        if M is None:
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            M = torch.rand((E, C), generator=generator)
        M = torch.as_tensor(M, dtype=torch.float32)
        self.register_buffer("M", M)
        self.register_buffer("M_pinv", torch.linalg.pinv(M.double()).float())
        self.to(device)

    def A(self, x, M=None, **params):
        M = self.M if M is None else M
        with exact_f32(x.device.type):
            return torch.einsum("ec,behw->bchw", M, x.float())

    def A_adjoint(self, y, M=None, **params):
        M = self.M if M is None else M
        with exact_f32(y.device.type):
            return torch.einsum("ce,bchw->behw", M.T, y.float())

    def A_dagger(self, y, **params):
        with exact_f32(y.device.type):
            return torch.einsum("ce,bchw->behw", self.M_pinv, y.float())


class CompressiveSpectralImaging(LinearPhysics):
    r"""The CASSI hyperspectral camera (misc.py:182): ``y = mean_c S M x``
    (``"sd"``, single disperser) or ``mean_c S^-1 M S x`` (``"ss"``,
    spatial-spectral), M a binary coded aperture, S a shear of channel c by
    c pixels along H (``shear_dir="h"``) or W.

    :param img_size: ``(C, H, W)``.
    :param mask: a float, the probability that an aperture pixel is open
        (drawn from ``generator``, seeded from ``seed`` if None), or the
        mask ``(C, H, W)`` / ``(1, C, H, W)``; None means 0.5.
    :param device: where the mask lives; the CUDA device by default.
    """

    def __init__(self, img_size, mask=None, mode: str = "ss", shear_dir: str = "h",
                 generator=None, seed: int = 0, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        self.img_size = tuple(img_size)
        if mode not in ("sd", "ss"):
            raise ValueError("mode must be 'sd' or 'ss'")
        if shear_dir not in ("h", "w"):
            raise ValueError("shear_dir must be 'h' or 'w'")
        self.mode = mode
        self.shear_dir = shear_dir
        if mask is None:
            mask = 0.5
        if isinstance(mask, float):
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            mask = (torch.rand((1,) + self.img_size, generator=generator) < mask).float()
        else:
            mask = torch.as_tensor(mask, dtype=torch.float32)
            if mask.dim() == 3:
                mask = mask[None]
        self.register_buffer("mask", mask)
        self.to(device)

    @property
    def C(self):
        return self.img_size[0]

    def pad(self, x):
        """A zero pad of C - 1 pixels at the bottom (or right) (misc.py:224)."""
        p = self.C - 1
        return torch.nn.functional.pad(x, (0, 0, 0, p) if self.shear_dir == "h" else (0, p))

    def crop(self, x):
        """Undo :meth:`pad` (misc.py:232)."""
        p = self.C - 1
        if self.shear_dir == "h":
            return x[:, :, :x.shape[-2] - p, :]
        return x[:, :, :, :x.shape[-1] - p]

    def shear(self, x, un: bool = False):
        """The shear of channel c by c pixels; ``un`` the opposite way
        (misc.py:239)."""
        return self._shear(x, inverse=un)

    def flatten(self, x):
        """The mean over the channels (misc.py:244)."""
        return x.mean(dim=1, keepdim=True)

    def unflatten(self, y):
        """A flat measurement spread back over the C channels (misc.py:248)."""
        return y.repeat_interleave(self.C, dim=1) / self.C

    def _shear(self, x, inverse: bool = False):
        ax = -2 if self.shear_dir == "h" else -1
        return torch.stack([torch.roll(x[:, c], -c if inverse else c, dims=ax)
                            for c in range(x.shape[1])], dim=1)

    def A(self, x, mask=None, **params):
        m = self.mask if mask is None else mask
        if self.mode == "ss":
            out = self._shear(self._shear(x) * m, inverse=True)
        else:
            out = self._shear(x * m)
        return out.mean(dim=1, keepdim=True)

    def A_adjoint(self, y, mask=None, **params):
        m = self.mask if mask is None else mask
        xe = self.unflatten(y)
        if self.mode == "ss":
            return self._shear(self._shear(xe) * m, inverse=True)
        return m * self._shear(xe, inverse=True)

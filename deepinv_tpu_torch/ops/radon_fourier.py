"""Gather-free Radon transform by FFT three-shear rotation (port of
deepinv_tpu/ops/radon_fourier.py).

Each rotation is three shears, ``R(t) = S_u(a) S_v(b) S_u(a)`` with ``a =
-tan(t/2)``, ``b = sin(t)``, each applied as an FFT phase ramp: exact sinc
interpolation, no gather. Angles are first reduced to a quarter turn ``k``
(``rot90`` about the image centre before the zero embedding) and a residual
``|t| <= 45`` degrees; the embedding grid is the next even 5-smooth size at
least ``2 W`` (:func:`_next_smooth`, :34). Conventions are ``ops.radon``'s.

:class:`RadonFourierPlan` is the shear plan, built once (the quadrant
groups, :func:`_quadrant_groups` :93, their residual shears and the order
that puts the columns back in angle order) as buffers. :func:`radon_fourier`
(:101) and :func:`iradon_fourier` (:141) keep the JAX package's signatures;
the adjoint is the autograd transpose of the forward
(:func:`~deepinv_tpu_torch.core.linear_transpose`), as JAX's is
``jax.linear_transpose``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.linalg import linear_transpose
from .radon import _circle_mask, _pad_image, ramp_filter, radon_output_size

__all__ = ["RadonFourierPlan", "radon_fourier", "iradon_fourier"]


def _next_smooth(n: int) -> int:
    """Smallest even 5-smooth integer >= n (radon_fourier.py:34)."""
    best = None
    a = 1
    while a <= 4 * n:
        b = a
        while b <= 4 * n:
            c = b
            while c <= 4 * n:
                if c >= n and c % 2 == 0 and (best is None or c < best):
                    best = c
                c *= 5
            b *= 3
        a *= 2
    return best if best is not None else n


def _fft_shear(stack, amounts, freqs, other, dim: int):
    """Shear the ``(..., T, G, G)`` complex stack along ``dim`` (-2: rows,
    -1: cols) by ``amounts[t] * (other coordinate - centre)``
    (radon_fourier.py:53): a phase ramp on that axis' FFT."""
    F_ = torch.fft.fft(stack, dim=dim)
    if dim == -2:
        arg = amounts[:, None, None] * freqs[None, :, None] * other[None, None, :]
    else:
        arg = amounts[:, None, None] * other[None, :, None] * freqs[None, None, :]
    phase = torch.polar(torch.ones_like(arg), 2 * math.pi * arg)
    return torch.fft.ifft(F_ * phase, dim=dim)


def _quadrant_groups(theta_deg) -> dict:
    """``{k: [(angle index, residual degrees)]}``: each angle as ``k``
    quarter turns and a residual in [-45, 45] (radon_fourier.py:93)."""
    groups = {}
    for i, th in enumerate(np.asarray(theta_deg, np.float64)):
        t = th % 360.0
        k = int(np.round(t / 90.0)) % 4
        groups.setdefault(k, []).append((i, t - 90.0 * np.round(t / 90.0)))
    return groups


class RadonFourierPlan(nn.Module):
    """The shear projector for ``img_width`` images and angles ``theta`` in
    degrees: per quarter turn the residual shears ``a`` and ``b`` (buffers
    ``a{k}``, ``b{k}``), the FFT frequencies and centred coordinates of the
    ``G x G`` grid, and ``order``, which puts the groups' columns back in
    angle order."""

    def __init__(self, img_width: int, theta, circle: bool = False):
        super().__init__()
        self.img_width, self.circle = int(img_width), circle
        W = radon_output_size(self.img_width, circle)
        self.W, self.G = W, _next_smooth(2 * W)
        self.before = (self.G - W) // 2
        center = self.before + (W - 1) / 2.0
        self.n_angles = len(np.atleast_1d(theta))
        self.groups = []
        done = []
        for k, items in _quadrant_groups(theta).items():
            resid = torch.as_tensor(np.deg2rad([r for _, r in items]), dtype=torch.float32)
            self.register_buffer(f"a{k}", -torch.tan(resid / 2.0))
            self.register_buffer(f"b{k}", torch.sin(resid))
            self.groups.append(k)
            done += [i for i, _ in items]
        self.register_buffer("order", torch.as_tensor(np.argsort(done), dtype=torch.long))
        self.register_buffer("freqs", torch.fft.fftfreq(self.G))
        self.register_buffer("other", torch.arange(self.G, dtype=torch.float32) - center)
        self.register_buffer("mask", torch.from_numpy(_circle_mask(W)) if circle else None)

    def project(self, x):
        """Sinogram ``(B, C, W, n_angles)`` of ``(B, C, W0, W0)`` images
        (radon_fourier.py:101)."""
        x = _pad_image(x, self.circle)
        if self.circle:
            x = x * self.mask
        B, C, W = x.shape[0], x.shape[1], self.W
        G, before = self.G, self.before
        cols = []
        for k in self.groups:
            a, b = getattr(self, f"a{k}"), getattr(self, f"b{k}")
            xk = torch.rot90(x, k=-k, dims=(-2, -1))
            emb = F.pad(xk, (before, G - W - before, before, G - W - before))
            stack = emb.reshape(B * C, 1, G, G).to(torch.complex64)
            stack = _fft_shear(stack, a, self.freqs, self.other, -2)
            stack = _fft_shear(stack, b, self.freqs, self.other, -1)
            stack = _fft_shear(stack, a, self.freqs, self.other, -2)
            cols.append(stack.sum(dim=-2).real[..., before:before + W])   # (BC, T, W)
        proj = torch.cat(cols, dim=1).index_select(1, self.order)
        return proj.movedim(1, 2).reshape(B, C, W, self.n_angles).to(x.dtype)

    def backproject(self, sino):
        """The exact transpose of :meth:`project` onto ``(B, C, W0, W0)``
        images."""
        B, C = sino.shape[:2]
        return linear_transpose(self.project, sino, (B, C, self.img_width, self.img_width))

    def filtered_backproject(self, sino, filtered: bool = True):
        """Ramp filter, :meth:`backproject`, and FBP's ``pi / (2 n_angles)``
        (radon_fourier.py:141)."""
        if filtered:
            sino = ramp_filter(sino)
        return self.backproject(sino) * (math.pi / (2 * self.n_angles))


def radon_fourier(x, theta, circle: bool = False):
    """Radon transform ``(B, C, W0, W0) -> (B, C, n_det, n_angles)`` by FFT
    shears (radon_fourier.py:101)."""
    return RadonFourierPlan(x.shape[-1], theta, circle).to(x.device).project(x)


def iradon_fourier(sino, theta, circle: bool = False, filtered: bool = True,
                   out_size: int | None = None):
    """(Filtered) backprojection as the transpose of :func:`radon_fourier`
    (radon_fourier.py:141)."""
    n_det = sino.shape[-2]
    if circle:
        W0 = n_det
    else:
        W0 = out_size if out_size is not None else int(math.floor(math.sqrt(n_det ** 2 / 2.0)))
    plan = RadonFourierPlan(W0, theta, circle).to(sino.device)
    return plan.filtered_backproject(sino, filtered)

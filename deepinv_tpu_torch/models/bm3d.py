"""BM3D denoiser (port of deepinv_tpu/models/bm3d.py; Dabov et al. 2007):
block matching, a 3D transform (the 8x8 DCT as one 64x64 matmul and an
orthonormal Haar transform along the group), hard thresholding, and a
Wiener stage re-matched on the basic estimate.

Block matching is an offset scan, as in the JAX package: for each offset of
the search window, the patch distance of every reference position at once
from an integral image of the squared difference, then the ``K`` nearest
offsets of each reference. The JAX ``vmap`` over the ``B*C`` planes
(bm3d.py:219) is one batched pass here; the offsets go through in chunks.

Two places may differ from the JAX results:

- ties: ``lax.top_k`` keeps the lower index of equal distances; here a
  stable sort does the same. The zero offset is sorted first
  (bm3d.py:121-124), so it leads its own group;
- the aggregation's scatter-add (``.at[lin].add``, bm3d.py:178-179) is
  ``index_add_``, which on a CUDA device adds with atomics in no fixed order:
  the output is not bit-reproducible there.

``sigma.reshape(-1)[0]`` (bm3d.py:217) takes the first sample's sigma for the
whole batch, as the JAX package does (ROADMAP queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .base import Denoiser

__all__ = ["BM3D"]

# offsets whose distance maps are computed at once (memory: planes x chunk x H x W)
_OFFSET_CHUNK = 64


def _dct_matrix(n: int) -> np.ndarray:
    """The orthonormal DCT-II matrix (bm3d.py:39)."""
    k = np.arange(n)
    M = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    M[0] *= 1.0 / math.sqrt(n)
    M[1:] *= math.sqrt(2.0 / n)
    return M.astype(np.float32)


def _dct2_matrix(p: int) -> np.ndarray:
    """The ``(p^2, p^2)`` matrix of the orthonormal 2D DCT of a flattened
    patch (bm3d.py:47)."""
    D = _dct_matrix(p)
    return np.kron(D, D).astype(np.float32)


def _haar_matrix(n: int) -> np.ndarray:
    """The orthonormal full Haar decomposition, ``n`` a power of two
    (bm3d.py:53)."""
    if n == 1:
        return np.array([[1.0]], np.float32)
    H = _haar_matrix(n // 2)
    top = np.kron(H, np.array([1.0, 1.0]))
    bot = np.kron(np.eye(n // 2), np.array([1.0, -1.0]))
    return (np.vstack([top, bot]) / math.sqrt(2.0)).astype(np.float32)


def _integral_patch_sums(s, p):
    """The sum of ``s`` over every ``p x p`` window of its last two axes,
    ``(..., H, W)`` to ``(..., H-p+1, W-p+1)`` (bm3d.py:64)."""
    ii = F.pad(torch.cumsum(torch.cumsum(s, -2), -1), (1, 0, 1, 0))
    return ii[..., p:, p:] - ii[..., :-p, p:] - ii[..., p:, :-p] + ii[..., :-p, :-p]


def _extract_patches(img, p):
    """``(N, H, W)`` to its ``(N, nH*nW, p*p)`` stride-1 patches, positions
    row-major (bm3d.py:72)."""
    return F.unfold(img[:, None], p).transpose(1, 2)


class BM3D(Denoiser):
    """BM3D (bm3d.py:81), both stages, the DCT as the spatial transform.

    :param patch_size: block size.
    :param search_radius: the block-matching window's radius.
    :param search_step: the stride of candidate offsets in the window.
    :param ref_stride: the stride between reference blocks.
    :param ht_group_size: the hard-thresholding stage's group size.
    :param wiener_group_size: the Wiener stage's group size.
    :param hard_threshold: the threshold in units of sigma.
    :param two_stage: run the Wiener stage.
    """

    def __init__(self, patch_size: int = 8, search_radius: int = 19, search_step: int = 1,
                 ref_stride: int = 3, ht_group_size: int = 16, wiener_group_size: int = 32,
                 hard_threshold: float = 3.0, two_stage: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.search_radius = search_radius
        self.search_step = search_step
        self.ref_stride = ref_stride
        self.ht_group_size = ht_group_size
        self.wiener_group_size = wiener_group_size
        self.hard_threshold = hard_threshold
        self.two_stage = two_stage

    def _offsets(self) -> np.ndarray:
        """The window's offsets, the zero offset first (bm3d.py:117)."""
        r, st = self.search_radius, self.search_step
        g = np.arange(-r, r + 1, st)
        dy, dx = np.meshgrid(g, g, indexing="ij")
        off = np.stack([dy.ravel(), dx.ravel()], 1)
        return off[np.argsort(np.abs(off).sum(1), kind="stable")]

    def _refs(self, H: int, W: int) -> np.ndarray:
        """The reference blocks' positions, the last row and column included
        (bm3d.py:160-163)."""
        p = self.patch_size
        nH, nW = H - p + 1, W - p + 1
        gy = np.arange(0, nH - 1, self.ref_stride).tolist() + [nH - 1]
        gx = np.arange(0, nW - 1, self.ref_stride).tolist() + [nW - 1]
        ryy, rxx = np.meshgrid(sorted(set(gy)), sorted(set(gx)), indexing="ij")
        return np.stack([ryy.ravel(), rxx.ravel()], 1)

    def _match(self, imgs, refs_yx, n_keep):
        """The ``n_keep`` most similar patch positions of each reference of
        each plane of ``imgs`` ``(N, H, W)``: ``(N, R, n_keep)`` linear
        positions in the stride-1 patch grid (bm3d.py:126)."""
        p = self.patch_size
        N, H, W = imgs.shape
        nH, nW = H - p + 1, W - p + 1
        dev = imgs.device
        offsets = torch.as_tensor(self._offsets(), device=dev)
        ry, rx = refs_yx[:, 0], refs_yx[:, 1]
        rows, cols = torch.arange(H, device=dev), torch.arange(W, device=dev)
        dists = []
        for s in range(0, offsets.shape[0], _OFFSET_CHUNK):
            off = offsets[s:s + _OFFSET_CHUNK]
            # jnp.roll(img, (-dy, -dx)): the pixel at (y + dy, x + dx), wrapped
            iy = (rows[None, :] + off[:, :1]) % H
            ix = (cols[None, :] + off[:, 1:]) % W
            shifted = imgs[:, iy[:, :, None], ix[:, None, :]]  # (N, k, H, W)
            d = _integral_patch_sums((imgs[:, None] - shifted) ** 2, p)  # (N, k, nH, nW)
            vals = d[:, :, ry, rx]  # (N, k, R)
            cy, cx = ry[None] + off[:, :1], rx[None] + off[:, 1:]
            valid = (cy >= 0) & (cy < nH) & (cx >= 0) & (cx < nW)
            dists.append(torch.where(valid, vals, torch.full_like(vals, float("inf"))))
        dists = torch.cat(dists, 1).transpose(1, 2)  # (N, R, n_off)
        dists, idx = torch.sort(dists, dim=-1, stable=True)
        if bool(torch.isinf(dists[..., n_keep - 1]).any()):
            # the JAX gather takes such out-of-image candidates in silently
            # (ROADMAP queue 3)
            raise ValueError(f"BM3D: a reference block has fewer than {n_keep} candidates in "
                             f"its search window: widen search_radius or shrink the group")
        idx = idx[..., :n_keep]
        sel = offsets[idx]  # (N, R, n_keep, 2)
        return (ry[None, :, None] + sel[..., 0]) * nW + rx[None, :, None] + sel[..., 1]

    def _denoise_planes(self, noisy, sigma):
        """Both stages on ``noisy`` ``(N, H, W)`` (bm3d.py:154)."""
        p = self.patch_size
        N, H, W = noisy.shape
        nW = W - p + 1
        dev, dt = noisy.device, noisy.dtype
        D2 = torch.from_numpy(_dct2_matrix(p)).to(dev)
        refs_yx = torch.as_tensor(self._refs(H, W), device=dev)
        dct_patches = _extract_patches(noisy, p) @ D2.T  # (N, L, p²)
        oy, ox = torch.meshgrid(torch.arange(p, device=dev), torch.arange(p, device=dev),
                                indexing="ij")
        plane = (torch.arange(N, device=dev) * (H * W))[:, None]

        def gather(patches, members):
            """``patches[n, members[n]]``: ``(N, R, K, p²)``."""
            R, K = members.shape[1:]
            idx = members.reshape(N, R * K, 1).expand(N, R * K, patches.shape[-1])
            return patches.gather(1, idx).reshape(N, R, K, -1)

        def aggregate(groups_sp, weights, members):
            """Scatter the weighted spatial patches back onto the planes."""
            rows = (members // nW)[..., None] + oy.reshape(-1)
            cols = (members % nW)[..., None] + ox.reshape(-1)
            lin = ((rows * W + cols).reshape(N, -1) + plane).reshape(-1)
            w = weights[:, :, None, None]
            num = torch.zeros(N * H * W, dtype=dt, device=dev).index_add_(
                0, lin, (groups_sp * w).reshape(-1))
            den = torch.zeros(N * H * W, dtype=dt, device=dev).index_add_(
                0, lin, w.expand(groups_sp.shape).reshape(-1))
            return (num / den.clamp(min=1e-12)).reshape(N, H, W)

        # stage 1: hard thresholding
        K1 = self.ht_group_size
        Hk1 = torch.from_numpy(_haar_matrix(K1)).to(dev)
        members1 = self._match(noisy, refs_yx, K1)
        tf = torch.einsum("kl,nrld->nrkd", Hk1, gather(dct_patches, members1))
        keep = tf.abs() > self.hard_threshold * sigma
        keep[..., 0, 0] = True  # the group's DC
        nz = keep.sum((2, 3)).to(dt)
        w1 = 1.0 / (nz.clamp(min=1.0) * sigma ** 2 + 1e-12)
        back = torch.einsum("kl,nrld->nrkd", Hk1.T, tf * keep) @ D2
        basic = aggregate(back, w1, members1)
        if not self.two_stage:
            return basic

        # stage 2: Wiener filtering, matched on the basic estimate
        K2 = self.wiener_group_size
        Hk2 = torch.from_numpy(_haar_matrix(K2)).to(dev)
        members2 = self._match(basic, refs_yx, K2)
        basic_dct = _extract_patches(basic, p) @ D2.T
        g_noisy = torch.einsum("kl,nrld->nrkd", Hk2, gather(dct_patches, members2))
        g_basic = torch.einsum("kl,nrld->nrkd", Hk2, gather(basic_dct, members2))
        wiener = g_basic ** 2 / (g_basic ** 2 + sigma ** 2)
        w2 = 1.0 / ((wiener ** 2).sum((2, 3)) * sigma ** 2 + 1e-12)
        back2 = torch.einsum("kl,nrkd->nrld", Hk2, wiener * g_noisy) @ D2
        return aggregate(back2, w2, members2)

    def forward(self, x, sigma=0.05, **kwargs):
        B, C, H, W = x.shape
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1)[0]
        return self._denoise_planes(x.reshape(B * C, H, W), sigma).reshape(B, C, H, W)

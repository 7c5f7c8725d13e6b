"""Rotation (port of the exact rot90 subgroup of
deepinv_tpu/transform/geometric.py's ``Rotate``; its bilinear warp for other
angles waits, ROADMAP queue 1)."""

from __future__ import annotations

import torch

from .base import Transform

__all__ = ["Rotate"]


class Rotate(Transform):
    """Rotation by multiples of ``multiples`` degrees (geometric.py:76). Only
    the exact subgroup (``multiples`` and ``limits`` multiples of 90) is
    ported: each sample is rotated by ``torch.rot90`` (``jnp.rot90``'s
    direction)."""

    def __init__(self, multiples: float = 90.0, limits: float = 360.0, n_trans: int = 1):
        super().__init__(n_trans)
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

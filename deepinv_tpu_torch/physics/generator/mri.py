"""MRI k-space mask generators (port of
deepinv_tpu/physics/generator/mri.py).

Cartesian masks: the central phase-encode lines in full plus undersampled
outer lines along W, the same across channels and rows, drawn per sample
(and per frame, for the k-t masks of shape ``(B, C, T, H, W)``).

- ``RandomMaskGenerator``: ``n_lines`` outer columns without replacement
  from a uniform pdf (mri.py:134-158, :161);
- ``GaussianMaskGenerator``: the same from the tail-lifted Gaussian pdf
  (mri.py:180);
- ``EquispacedMaskGenerator``: equispaced columns at the centre-adjusted
  acceleration with a random offset per sample, sheared over time (:200);
- ``PolyOrderMaskGenerator``: a Bernoulli draw per column from the
  polynomial pdf scaled by bisection (:248).

Draws without replacement take the Gumbel top-k: the ``n_lines`` largest
``log(pdf) + g`` over the columns where the pdf is positive, with ``g`` one
standard Gumbel draw a column (:134-158).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .base import PhysicsGenerator

__all__ = ["BaseMaskGenerator", "GaussianMaskGenerator", "RandomMaskGenerator",
           "EquispacedMaskGenerator", "PolyOrderMaskGenerator"]


def _ceildiv(a, b):
    return -(a // -b)


class BaseMaskGenerator(PhysicsGenerator):
    """What the acceleration masks share (mri.py:49).

    :param img_size: ``(H, W)``, ``(C, H, W)`` or ``(C, T, H, W)``.
    :param acceleration: the acceleration factor.
    :param center_fraction: the fraction of central columns sampled in full;
        0.08 below acceleration 8 and 0.04 from there by default.
    """

    def __init__(self, img_size, acceleration: int = 4, center_fraction: float | None = None,
                 seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self.img_size = tuple(img_size)
        self.acc = acceleration
        if center_fraction is not None:
            self.center_fraction = center_fraction
        else:
            self.center_fraction = 0.08 if acceleration < 8 else 0.04
        if len(self.img_size) == 2:
            (self.H, self.W), self.C, self.T = self.img_size, 1, 0
        elif len(self.img_size) == 3:
            (self.C, self.H, self.W), self.T = self.img_size, 0
        elif len(self.img_size) == 4:
            self.C, self.T, self.H, self.W = self.img_size
        else:
            raise ValueError("img_size must be (H, W) or (C, H, W) or (C, T, H, W)")
        self.calculate_lines(self.W)

    def calculate_lines(self, W: int):
        """The numbers of outer and central lines of a mask of width ``W``
        (mri.py:85)."""
        self.n_center = int(self.center_fraction * W)
        self.n_lines = int(W // self.acc - self.n_center)
        if self.n_lines < 0:
            raise ValueError("center_fraction is too high for this acceleration factor.")
        if self.n_lines == 0:
            warnings.warn("Number of high frequency lines to be sampled is 0. Reduce "
                          "acceleration factor or reduce center_fraction.")
        return self

    def _center_slice(self, W: int) -> slice:
        return slice(W // 2 - self.n_center // 2, W // 2 + _ceildiv(self.n_center, 2))

    def get_pdf(self, W: int):
        """The unnormalised sampling density across the columns (mri.py:105)."""
        raise NotImplementedError

    def sample_mask(self, draws, B: int, T: int, H: int, W: int) -> torch.Tensor:
        """Line indicators ``(B, T, W)``."""
        raise NotImplementedError

    def sample(self, batch_size: int = 1, draws=None, img_size=None, **kwargs):
        B = 1 if batch_size == 0 else batch_size
        T = self.T if self.T > 0 else 1
        H, W = (self.H, self.W) if img_size is None else tuple(img_size)
        self.calculate_lines(W)
        if self.n_lines + self.n_center >= W:
            lines = torch.ones((B, T, W), device=self.device)
        else:
            lines = self.sample_mask(draws, B, T, H, W)
        mask = lines[:, None, :, None, :].expand(B, self.C, T, H, W).contiguous()
        if self.T == 0:
            mask = mask[:, :, 0]
        return {"mask": mask[0] if batch_size == 0 else mask}


class _WeightedLineMaskGenerator(BaseMaskGenerator):
    """Outer lines without replacement from ``get_pdf`` (mri.py:134)."""

    def sample_mask(self, draws, B, T, H, W):
        pdf = torch.as_tensor(self.get_pdf(W), dtype=torch.float32, device=self.device).clone()
        pdf[self._center_slice(W)] = 0.0
        pdf = pdf / pdf.sum()
        lines = torch.zeros((B, T, W), device=self.device)
        if self.n_lines > 0:
            g = draws.gumbel((B, T, W))
            scores = torch.where(pdf > 0, torch.log(pdf) + g, torch.full_like(g, -float("inf")))
            idx = torch.topk(scores, self.n_lines, dim=-1).indices
            lines.scatter_(-1, idx, 1.0)
        lines[..., self._center_slice(W)] = 1.0
        return lines


class RandomMaskGenerator(_WeightedLineMaskGenerator):
    """Uniform random undersampling (mri.py:161)."""

    def get_pdf(self, W: int):
        return torch.ones((W,), device=self.device)


class GaussianMaskGenerator(_WeightedLineMaskGenerator):
    """Gaussian-density undersampling (mri.py:180): the outer columns come
    from ``exp(-(x - W/2)^2 / (2 (W/10)^2)) + 1 / (2 acc)``."""

    def get_pdf(self, W: int):
        x = torch.arange(W, dtype=torch.float32, device=self.device)
        pdf = torch.exp(-(0.5 / (W / 10.0) ** 2) * (x - W / 2) ** 2)
        return pdf + (W / (2.0 * self.acc)) / W


class EquispacedMaskGenerator(BaseMaskGenerator):
    """Equispaced undersampling with a random offset a sample, sheared over
    time (mri.py:200)."""

    def get_pdf(self):
        raise NotImplementedError("get_pdf is undefined for this mask generator.")

    def sample_mask(self, draws, B, T, H, W):
        lines = torch.zeros((B, T, W), device=self.device)
        pad = (W - self.n_center + 1) // 2
        lines[:, :, pad:pad + self.n_center] = 1.0
        # the outer region's acceleration once the centre is counted (mri.py:224)
        accel = (self.acc * (self.n_center - W)) / (self.n_center * self.acc - W)
        offset = draws.randint(0, round(accel), (B,)).to(torch.float32)
        ks = torch.arange(W, dtype=torch.float32, device=self.device)
        ts = torch.arange(T, dtype=torch.float32, device=self.device)
        start = torch.remainder(ts[None, :] + offset[:, None], accel)           # (B, T)
        pos = start[..., None] + ks * accel                                      # (B, T, W)
        valid = (pos < W - 1).to(torch.float32)
        idx = torch.round(pos).to(torch.long).clamp(0, W - 1)
        sheared = torch.zeros((B, T, W), device=self.device).scatter_reduce(
            -1, idx, valid, "amax", include_self=True)
        return torch.maximum(lines, sheared)


class PolyOrderMaskGenerator(BaseMaskGenerator):
    """Polynomial variable-density Bernoulli sampling (mri.py:248): the pdf
    ``clamp((1 - r)^p + c, 0, 1)`` with ``c`` found by bisection so that its
    mean is ``1 / acceleration``, and one Bernoulli draw a column.

    :param poly_order: the polynomial's order.
    """

    def __init__(self, *args, poly_order: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.poly_order = poly_order
        self.pdf = torch.as_tensor(self.get_pdf(), dtype=torch.float32, device=self.device)

    def get_pdf(self, max_iter: int = 100, tol: float = 1e-3):
        W = self.W
        r = np.abs(np.linspace(-1, 1, W))
        pdf = (1 - r) ** self.poly_order
        center = self._center_slice(W)
        pdf[center] = 1.0
        a, b = -1.0, 1.0
        target = 1.0 / self.acc
        for _ in range(max_iter):
            c = (a + b) / 2
            scaled = np.clip(pdf + c, 0, 1)
            scaled[center] = 1.0
            frac = scaled.mean()
            if frac < target - tol:
                a = c
            elif frac > target + tol:
                b = c
            else:
                return scaled
        raise ValueError(f"get_pdf did not converge after {max_iter} iterations")

    def sample_mask(self, draws, B, T, H, W):
        if (H, W) != (self.H, self.W):
            raise ValueError("PolyOrderMaskGenerator pdf is precomputed for the constructor "
                             "img_size; step-time img_size override is not supported.")
        return (draws.uniform((B, T, W)) < self.pdf).to(torch.float32)

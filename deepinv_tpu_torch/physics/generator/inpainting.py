"""Inpainting and measurement-splitting mask generators (port of
deepinv_tpu/physics/generator/inpainting.py).

- ``BernoulliSplittingMaskGenerator`` (inpainting.py:44): i.i.d. pixels kept
  with probability ``split_ratio``; splitting a given mask keeps exactly
  ``int(split_ratio * n)`` of its ``n`` nonzero entries (a random
  permutation of them).
- ``MultiplicativeSplittingMaskGenerator`` (:204): the given mask times a
  mask of ``split_generator``.
- ``GaussianSplittingMaskGenerator`` (:246, the SSDU masks): removes
  ``ceil(n (1 - split_ratio))`` points, drawn without replacement (Gumbel
  top-k) from a centred Gaussian pdf off the always-kept centre block.
- ``Phase2Phase`` and ``Artifact2Artifact`` (:337, :361): the even frames,
  or one random chunk of frames, of dynamic ``(C, T, H, W)`` data.

The generators run on the host side of the loop, one sample after another,
like the JAX package's: each sample takes its draws in turn.
"""

from __future__ import annotations

import math
from warnings import warn

import torch

from .base import PhysicsGenerator

__all__ = ["BernoulliSplittingMaskGenerator", "GaussianSplittingMaskGenerator",
           "MultiplicativeSplittingMaskGenerator", "Phase2PhaseSplittingMaskGenerator",
           "Artifact2ArtifactSplittingMaskGenerator"]


def _given(mask) -> bool:
    """Whether ``mask`` is a mask to split (not None or a scalar)."""
    return mask is not None and torch.as_tensor(mask).numel() > 1


class BernoulliSplittingMaskGenerator(PhysicsGenerator):
    """Bernoulli splitting and inpainting masks (inpainting.py:44).

    :param img_size: the mask's shape without the batch, e.g. ``(C, H, W)``,
        ``(C, M)`` or ``(M,)``.
    :param split_ratio: the fraction of entries kept.
    :param pixelwise: keep or drop all channels of a pixel together.
    :param random_split_ratio: draw ``split_ratio`` from ``U(min_split_ratio,
        max_split_ratio)`` at each sample.
    """

    def __init__(self, img_size, split_ratio: float, pixelwise: bool = True,
                 random_split_ratio: bool = False, min_split_ratio: float = 0.0,
                 max_split_ratio: float = 1.0, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self.img_size = (img_size,) if isinstance(img_size, int) else tuple(img_size)
        self.split_ratio = split_ratio
        self.pixelwise = pixelwise
        self.random_split_ratio = random_split_ratio
        self.min_split_ratio = min_split_ratio
        self.max_split_ratio = max_split_ratio

    def sample(self, batch_size=1, draws=None, input_mask=None, img_size=None, **kwargs):
        if input_mask is not None and img_size is not None:
            raise ValueError("Only input_mask or img_size can be passed, but not both.")
        batched = False
        if input_mask is not None:
            input_mask = torch.as_tensor(input_mask, device=self.device)
            if input_mask.dim() > len(self.img_size):
                if input_mask.shape[0] > 1:
                    batch_size, batched = input_mask.shape[0], True
                else:
                    input_mask = input_mask[0]
        if batch_size is None:
            return {"mask": self.batch_sample(draws, input_mask=input_mask, img_size=img_size,
                                              **kwargs)}
        masks = [self.batch_sample(draws, input_mask=input_mask[b] if batched else input_mask,
                                   img_size=img_size, **kwargs) for b in range(batch_size)]
        return {"mask": torch.stack(masks)}

    def batch_step(self, input_mask=None, img_size=None, generator=None) -> dict:
        """One mask without the batch dimension (inpainting.py:106)."""
        im = None if input_mask is None else torch.as_tensor(input_mask)[None]
        out = self.step(1, generator=generator, input_mask=im, img_size=img_size)
        return {k: v[0] if isinstance(v, torch.Tensor) and v.dim() else v
                for k, v in out.items()}

    def check_pixelwise(self, input_mask=None) -> bool:
        """Whether this mask can be drawn pixel by pixel (inpainting.py:115):
        the channel must lead a shape of three dimensions or more, and the
        channels of a given mask must all be the same."""
        if not self.pixelwise:
            return False
        if len(self.img_size) == 1:
            warn("For 1D img_size, pixelwise must be False.")
            return False
        if len(self.img_size) == 2:
            warn("Generating pixelwise mask assumes channel in first dimension. For 2D images "
                 "ensure img_size is at least 3D.")
        if not _given(input_mask):
            return True
        m = torch.as_tensor(input_mask)
        if m.dim() == 1:
            warn("input_mask is only 1D so pixelwise cannot be used.")
            return False
        if m.dim() == 2 and len(self.img_size) > 2:
            return False
        if not bool((m == m[:1]).all()):
            warn("To use pixelwise, all channels must be same.")
            return False
        return True

    def _draw_split_ratio(self, draws):
        if self.random_split_ratio:
            u = float(draws.uniform(()))
            return self.min_split_ratio + u * (self.max_split_ratio - self.min_split_ratio)
        return self.split_ratio

    def batch_sample(self, draws, input_mask=None, img_size=None):
        """One mask without the batch dimension (inpainting.py:153)."""
        pixelwise = self.check_pixelwise(input_mask)
        img_size = (self.img_size if img_size is None
                    else self.img_size[:-2] + tuple(img_size)[-2:])
        split_ratio = self._draw_split_ratio(draws)
        if _given(input_mask):
            input_mask = torch.as_tensor(input_mask, device=self.device)
            src = input_mask[0] if pixelwise else input_mask
            idx = torch.nonzero(src != 0)
            perm = draws.permutation(idx.shape[0])
            keep = idx[perm[:int(float(split_ratio) * idx.shape[0])]]
            mask = torch.zeros(src.shape, dtype=input_mask.dtype, device=self.device)
            mask[tuple(keep.T)] = 1
            return torch.stack([mask] * input_mask.shape[0]) if pixelwise else mask
        aux = draws.uniform(img_size)
        if pixelwise:
            aux = aux[:1].expand(img_size)
        return (aux <= split_ratio).to(torch.float32)


class MultiplicativeSplittingMaskGenerator(BernoulliSplittingMaskGenerator):
    """The step's ``input_mask`` (an acceleration mask) times a fresh mask of
    ``split_generator`` (inpainting.py:204).

    :param img_size: the mask's shape without the batch.
    :param split_generator: the generator of the splitting masks.
    """

    def __init__(self, img_size, split_generator, seed: int = 0, device=None):
        super().__init__(img_size, split_ratio=0.0, pixelwise=True, seed=seed,
                         device=device if device is not None else split_generator.device)
        self.split_generator = split_generator

    def batch_sample(self, draws, input_mask=None, img_size=None):
        if _given(input_mask):
            input_mask = torch.as_tensor(input_mask, device=self.device)
            mask = self.split_generator.sample(1, draws,
                                               img_size=tuple(input_mask.shape[-2:]))["mask"][0]
            if input_mask.shape[-2:] != mask.shape[-2:]:
                raise ValueError("Input mask should be same shape as generated mask, but input "
                                 f"has shape {tuple(input_mask.shape)} and generated has shape "
                                 f"{tuple(mask.shape)}")
            return mask * input_mask
        return self.split_generator.sample(1, draws, img_size=img_size)["mask"][0]


class GaussianSplittingMaskGenerator(BernoulliSplittingMaskGenerator):
    """Spatial-Gaussian splitting masks (inpainting.py:246): removes
    ``ceil(n (1 - split_ratio))`` points from the input mask, drawn without
    replacement from a centred Gaussian pdf with the ``center_block`` always
    kept. Static ``(C, H, W)`` and dynamic ``(C, T, H, W)`` masks.

    :param std_scale: the Gaussian's deviations are ``(H, W) / std_scale``.
    :param center_block: the always-kept central block (int or ``(h, w)``).
    """

    def __init__(self, img_size, split_ratio: float, pixelwise: bool = True,
                 std_scale: float = 4.0, center_block=(8, 8), seed: int = 0, device=None):
        super().__init__(img_size, split_ratio=split_ratio, pixelwise=pixelwise, seed=seed,
                         device=device)
        if len(self.img_size) < 3:
            raise ValueError("img_size should be at least of shape (C, H, W). Gaussian "
                             "splitting mask does not support signals of shape (C, M).")
        self.std_scale = std_scale
        self.center_block = ((center_block, center_block) if isinstance(center_block, int)
                             else tuple(center_block))

    def get_pdf(self, shape):
        """The centred anisotropic Gaussian (inpainting.py:272)."""
        nx, ny = shape
        x, y = torch.meshgrid(torch.arange(nx, device=self.device),
                              torch.arange(ny, device=self.device), indexing="ij")
        return torch.exp(-((x - nx // 2) ** 2 / (2 * (nx / self.std_scale) ** 2)
                           + (y - ny // 2) ** 2 / (2 * (ny / self.std_scale) ** 2)))

    def batch_sample(self, draws, input_mask=None, img_size=None):
        pixelwise = self.check_pixelwise()
        T = self.img_size[1] if len(self.img_size) > 3 else 1
        C = self.img_size[0] if not pixelwise else 1
        if not _given(input_mask):
            img_size = img_size if img_size is not None else self.img_size
            input_mask = torch.ones((C, T) + tuple(img_size[-2:]), device=self.device)
        m = torch.as_tensor(input_mask, dtype=torch.float32, device=self.device)
        no_channel = m.dim() < len(self.img_size)
        if no_channel:
            m, C = m[None], 1
        if m.dim() == 3:
            m = m[:, None]
        if pixelwise:
            m = m[:1]
        nx, ny = m.shape[-2:]
        cx, cy = nx // 2, ny // 2
        bh, bw = self.center_block
        prob = m * self.get_pdf((nx, ny))
        prob[..., cx - bh // 2:cx + bh // 2, cy - bw // 2:cy + bw // 2] = 0
        prob = (prob / prob.sum(dim=(-2, -1), keepdim=True)).reshape(C, T, -1)
        g = draws.gumbel((C, T, nx * ny))
        scores = torch.where(prob > 0, torch.log(prob) + g, torch.full_like(g, -float("inf")))
        removed = torch.zeros_like(prob)
        for c in range(C):
            for t in range(T):
                n_remove = math.ceil(float(m[c, t].sum()) * (1 - self.split_ratio))
                # at most the removable support: the centre block and the
                # points already out of the mask have zero probability
                n_avail = int((prob[c, t] > 0).sum())
                removed[c, t, torch.topk(scores[c, t], min(n_remove, n_avail)).indices] = 1
        out = m - removed.reshape(m.shape)
        if len(self.img_size) == 3:
            out = out[:, 0]
        if self.pixelwise and not no_channel:
            out = torch.cat([out] * self.img_size[0], 0)
        return out


class Phase2PhaseSplittingMaskGenerator(BernoulliSplittingMaskGenerator):
    """The even frames of dynamic ``(C, T, H, W)`` data (inpainting.py:337)."""

    def __init__(self, img_size, seed: int = 0, device=None):
        super().__init__(img_size, split_ratio=None, pixelwise=None, seed=seed, device=device)

    def _input(self, input_mask, img_size):
        """The given mask, of ``img_size``'s shape, or ones (inpainting.py:344)."""
        if len(self.img_size) != 4:
            raise ValueError("Default img_size must be of shape (C, T, H, W)")
        if _given(input_mask):
            m = torch.as_tensor(input_mask, dtype=torch.float32, device=self.device)
            if tuple(m.shape) != self.img_size:
                raise ValueError("input_mask must be same shape as default img_size")
            return m
        size = self.img_size if img_size is None else self.img_size[:-2] + tuple(img_size)[-2:]
        return torch.ones(size, device=self.device)

    def batch_sample(self, draws, input_mask=None, img_size=None):
        m = self._input(input_mask, img_size)
        out = torch.zeros_like(m)
        out[:, ::2] = m[:, ::2]
        return out


class Artifact2ArtifactSplittingMaskGenerator(Phase2PhaseSplittingMaskGenerator):
    """One random chunk of ``split_size`` frames of dynamic data
    (inpainting.py:361). ``persist_prev=True`` draws a chunk other than the
    previous one (and keeps the previous chunk length).

    :param split_size: the chunk length (dividing T), or a tuple of lengths
        one of which is drawn at each sample.
    """

    def __init__(self, img_size, split_size=2, seed: int = 0, device=None):
        super().__init__(img_size, seed=seed, device=device)
        self.split_size = split_size
        self.prev_idx = None
        self.prev_split_size = None

    def batch_sample(self, draws, input_mask=None, img_size=None, persist_prev: bool = False):
        m = self._input(input_mask, img_size)
        split_size = self.split_size
        if isinstance(self.split_size, (tuple, list)):
            if persist_prev:
                split_size = self.prev_split_size
            else:
                pick = int(draws.randint(0, len(self.split_size)))
                self.prev_split_size = split_size = self.split_size[pick]
        T = m.shape[1]
        n_chunks = T // split_size
        if persist_prev and self.prev_idx is not None:
            idx = (self.prev_idx + 1 + int(draws.randint(0, n_chunks - 1))) % n_chunks
        else:
            idx = int(draws.randint(0, n_chunks))
        self.prev_idx = idx
        sel = (torch.arange(T, device=self.device) // split_size == idx).to(m.dtype)
        return m * sel[None, :, None, None]

"""2D -> 3D weight inflation (port of deepinv_tpu/models/utils3d.py): a 3D
network initialized from a 2D checkpoint, axially (the 2D kernel on the
central depth slice) or isotropically (the mean of the three axis-aligned
placements)."""

from __future__ import annotations

import numpy as np
import torch

from .layers import Conv3d, ConvTranspose3d

__all__ = ["initialize_3d_from_2d"]


def _inflate(w2d: torch.Tensor, k: int, isotropic: bool) -> torch.Tensor:
    """``(O, I, kh, kw) -> (O, I, k, kh, kw)`` (utils3d.py:35). An odd ``k``
    places the kernel at the centre ``k // 2``, the JAX package's deliberate
    departure from upstream's ``k // 2 + 1`` (utils3d.py:45-49), so that a
    depth-constant volume maps to the 2D result slice by slice."""
    O, I = w2d.shape[:2]
    if k % 2 == 1:
        c = k // 2
        w = w2d.new_zeros((O, I, k) + tuple(w2d.shape[2:]))
        if isotropic:
            w[:, :, c] += w2d
            w[:, :, :, c, :] += w2d
            w[..., c] += w2d
            return w / 3.0
        w[:, :, c] = w2d
        return w
    if isotropic:
        return (w2d[:, :, None] / k + w2d[:, :, :, None] / k + w2d[..., None] / k) / 3.0
    return (w2d[:, :, None] / k).expand((O, I, k) + tuple(w2d.shape[2:])).clone()


def initialize_3d_from_2d(model_3d, ckpt_2d: dict, isotropic: bool = False):
    """Set every :class:`Conv3d` / :class:`ConvTranspose3d` of ``model_3d``
    whose ``<module name>.weight`` is in ``ckpt_2d`` from that 2D kernel, and
    its bias from ``<module name>.bias``, in place (utils3d.py:62). Module
    names are the port's, which are the JAX package's tree paths.

    :param ckpt_2d: ``{name: (O, I, kh, kw) array or tensor}``.
    :param isotropic: average the three axis-aligned placements.
    :return: ``model_3d``.
    """
    def get(name):
        v = ckpt_2d.get(name)
        return None if v is None else torch.as_tensor(np.asarray(v), dtype=torch.float32)

    with torch.no_grad():
        for name, mod in model_3d.named_modules():
            if not isinstance(mod, (Conv3d, ConvTranspose3d)):
                continue
            w2d = get(f"{name}.weight")
            if w2d is None:
                continue
            mod.weight.copy_(_inflate(w2d, mod.weight.shape[2], isotropic))
            b = get(f"{name}.bias")
            if mod.bias is not None and b is not None:
                mod.bias.copy_(b)
    return model_3d

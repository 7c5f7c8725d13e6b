"""Model helpers (port of deepinv_tpu/models/utils.py)."""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["test_pad"]


def test_pad(model, x, modulo: int = 16):
    """Edge-pad the two spatial dims of ``x`` to multiples of ``modulo``, run
    ``model``, crop back (deepinv_tpu/models/utils.py:10)."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (0, (-W) % modulo, 0, (-H) % modulo), mode="replicate")
    return model(xp)[..., :H, :W]

"""Radon-transform helpers the Fourier-slice projector uses (port of
deepinv_tpu/ops/radon.py): the detector size :func:`radon_output_size` (:27),
the diagonal padding :func:`_pad_image` (:33) and the inscribed-circle mask
:func:`_circle_mask` (:48). The gather projector ``radon``, ``iradon``,
``ramp_filter`` and ``fanbeam`` wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["radon_output_size"]


def radon_output_size(in_size: int, circle: bool = False) -> int:
    """Detector pixels for a square ``in_size`` image (radon.py:27):
    ``in_size`` inside the circle, else the padded diagonal."""
    if circle:
        return in_size
    return in_size + int(math.ceil(math.sqrt(2) * in_size - in_size))


def _pad_image(x: torch.Tensor, circle: bool) -> torch.Tensor:
    """Zero-pad the two last dims to the diagonal, centred (radon.py:33)."""
    if circle:
        return x
    W = x.shape[-1]
    pad = int(math.ceil(math.sqrt(2) * W - W))
    before = (W + pad) // 2 - W // 2
    return F.pad(x, (before, pad - before, before, pad - before))


def _circle_mask(W: int) -> np.ndarray:
    """``(W, W)`` float32 indicator of the inscribed disc (radon.py:48)."""
    ax = 2 * np.arange(W) / (W - 1) - 1.0
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    return (yy ** 2 + xx ** 2 <= 1).astype(np.float32)

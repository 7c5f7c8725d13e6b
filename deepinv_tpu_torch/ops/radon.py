"""Radon-transform helpers the Fourier-slice projector uses (port of
deepinv_tpu/ops/radon.py): the detector size :func:`radon_output_size` (:27),
the diagonal padding :func:`_pad_image` (:33), the inscribed-circle mask
:func:`_circle_mask` (:48) and the FBP :func:`ramp_filter` (:89). The gather
projector ``radon``, ``iradon`` and ``fanbeam`` wait for ROADMAP queue 1
item 8.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["radon_output_size", "ramp_filter"]


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


def ramp_filter(sino: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Ramp filter along the detector axis of ``(..., n_det, n_angles)``
    sinograms (radon.py:89): zero-pad to a power of two (at least 64 and
    ``2 n_det``), multiply by the FFT of the band-limited spatial ramp (Kak &
    Slaney), crop."""
    N = sino.shape[-2]
    size = max(64, int(2 ** math.ceil(math.log2(2 * N))))
    n = np.concatenate([np.arange(1, size / 2 + 1, 2), np.arange(size / 2 - 1, 0, -2)])
    f = np.zeros(size, np.float64)
    f[0] = 0.25
    f[1::2] = -1.0 / (np.pi * n) ** 2
    ramp = torch.as_tensor(2 * np.real(np.fft.fft(f)), dtype=dtype).to(sino.device)
    sp = torch.fft.fft(F.pad(sino, (0, 0, 0, size - N)), dim=-2)
    filtered = torch.fft.ifft(sp * ramp[:, None], dim=-2).real
    return filtered[..., :N, :].to(sino.dtype)

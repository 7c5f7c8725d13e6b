"""MATLAB-compatible ``imresize`` (port of deepinv_tpu/ops/imresize.py):
antialiased cubic interpolation, the kernel widened by ``1 / scale`` when
downscaling, mirrored at the borders, applied along each axis as a dense
``(out, in)`` matrix built on the host with numpy (``torch.matmul``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["imresize_matlab"]


def _cubic(x):
    ax = np.abs(x)
    return (((1.5 * ax - 2.5) * ax * ax + 1) * (ax <= 1)
            + (((-0.5 * ax + 2.5) * ax - 4) * ax + 2) * ((1 < ax) & (ax <= 2)))


def _weights(in_len: int, out_len: int, scale: float) -> np.ndarray:
    """The ``(out_len, in_len)`` float32 resize matrix of one axis
    (imresize.py:25)."""
    kernel_width = 4.0
    if scale < 1:
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(P)[None]
    if scale < 1:
        w = scale * _cubic(scale * (u[:, None] - idx))
    else:
        w = _cubic(u[:, None] - idx)
    w = w / np.sum(w, axis=1, keepdims=True)
    # mirrored borders: idx is 1-based, the 0-based entry is aux[(idx - 1) mod 2n]
    aux = np.concatenate([np.arange(in_len), np.arange(in_len)[::-1]])
    idx = aux[np.mod(idx.astype(np.int64) - 1, 2 * in_len)]
    M = np.zeros((out_len, in_len))
    for r in range(out_len):
        np.add.at(M[r], idx[r], w[r])
    return M.astype(np.float32)


def imresize_matlab(x: torch.Tensor, scale=None, out_shape=None) -> torch.Tensor:
    """MATLAB ``imresize`` with bicubic antialiasing of ``(B, C, H, W)``
    (imresize.py:50): by ``scale``, or to ``out_shape``."""
    H, W = x.shape[-2:]
    if out_shape is None:
        oh, ow = int(np.ceil(H * scale)), int(np.ceil(W * scale))
        sh = sw = scale
    else:
        oh, ow = out_shape
        sh, sw = oh / H, ow / W
    Mh = torch.from_numpy(_weights(H, oh, sh)).to(x.device, x.dtype)
    Mw = torch.from_numpy(_weights(W, ow, sw)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(Mh, x), Mw.T)

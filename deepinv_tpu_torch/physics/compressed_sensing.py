"""Compressed sensing (port of deepinv_tpu/physics/compressed_sensing.py).

The dense form is one product with an ``m x n`` Gaussian matrix, pinned to
f32 (no TF32, no autocast: :func:`~deepinv_tpu_torch.core.exact_f32`). The
fast form is random signs, the orthonormal DST-I of the flattened image and
a row subset: at 256² the DST-I is an FFT of length 2(65536 + 1) = 2 x 65537,
a prime factor, which cuFFT computes by Bluestein's algorithm.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.linalg import exact_f32
from ..device import resolve_device
from ..ops.fourier import dst1
from .base import LinearPhysics

__all__ = ["CompressedSensing"]


class CompressedSensing(LinearPhysics):
    r"""``y = A x`` with an i.i.d. Gaussian ``A`` (compressed_sensing.py:22).

    :param m: number of measurements.
    :param img_size: ``(C, H, W)``.
    :param fast: the structured ``A = S F D`` (a row subset of the DST-I of
        random signs) in place of a dense matrix (:65-76).
    :param channelwise: the same matrix for each channel.
    :param matrix: the dense ``(m, n)`` matrix, already scaled by
        ``1/sqrt(m)``; drawn from ``generator`` where None.
    :param D: the fast form's ``(n,)`` signs; drawn where None.
    :param rows: the fast form's ``m`` kept rows of the DST-I; drawn where None.
    :param generator: a CPU ``torch.Generator`` for the tables (seeded from
        ``seed`` if None); the tables are made on the CPU and moved.
    :param device: where the tables live; the CUDA device by default.
    """

    def __init__(self, m: int, img_size, fast: bool = False, channelwise: bool = False,
                 matrix=None, D=None, rows=None, generator=None, seed: int = 0, device=None,
                 **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        self.m = int(m)
        self.img_size = tuple(img_size)
        self.fast = fast
        self.channelwise = channelwise
        n = math.prod(self.img_size)
        self.n = n // self.img_size[0] if channelwise else n
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        if fast:
            if D is None:
                D = (torch.rand(self.n, generator=generator) < 0.5).float() * 2 - 1
            if rows is None:
                rows = torch.randperm(self.n, generator=generator)[:self.m]
            self.register_buffer("D", torch.as_tensor(np.array(D), dtype=torch.float32))
            self.register_buffer("rows", torch.as_tensor(np.array(rows), dtype=torch.long))
            self.register_buffer("_A_mat", None)
        else:
            if matrix is None:
                matrix = torch.randn((self.m, self.n), generator=generator) / math.sqrt(self.m)
            self.register_buffer("_A_mat", torch.as_tensor(np.array(matrix)))
            self.register_buffer("D", None)
            self.register_buffer("rows", None)
        self.to(device)

    def _flatten(self, x):
        B = x.shape[0]
        if self.channelwise:
            return x.reshape(B * x.shape[1], -1), (B, x.shape[1])
        return x.reshape(B, -1), (B, None)

    def A(self, x, **params):
        v, (B, C) = self._flatten(x)
        if self.fast:
            y = dst1(v * self.D, axes=(-1,))[:, self.rows] * math.sqrt(self.n / self.m)
        else:
            with exact_f32(v.device.type):
                y = v.to(self._A_mat.dtype) @ self._A_mat.T
        return y.reshape(B, C, self.m) if C is not None else y

    def A_adjoint(self, y, **params):
        if self.channelwise:
            B, C = y.shape[:2]
            v = y.reshape(B * C, -1)
        else:
            B, C = y.shape[0], None
            v = y.reshape(B, -1)
        if self.fast:
            u = v.new_zeros((v.shape[0], self.n))
            u[:, self.rows] = v * math.sqrt(self.n / self.m)
            x = dst1(u, axes=(-1,)) * self.D
        else:
            with exact_f32(v.device.type):
                # A^H = conj(A)^T; conj is a no-op for the real default matrix
                x = v.to(self._A_mat.dtype) @ self._A_mat.conj()
        if C is not None:
            return x.reshape(B, C, *self.img_size[1:])
        return x.reshape(B, *self.img_size)

"""Structured random operators (port of
deepinv_tpu/physics/structured_random.py).

``A = crop(prod_i F D_i)``: random diagonals alternating with the
orthonormal DST-I over the image plane, the adjoint its autograd transpose
(the JAX package's ``jax.linear_transpose``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.linalg import linear_transpose
from ..device import resolve_device
from ..ops.fourier import dst1
from .base import LinearPhysics

__all__ = ["StructuredRandom", "compare_sizes", "generate_diagonal"]


def compare_sizes(input_shape, output_shape):
    """The element counts of the two shapes (structured_random.py:22)."""
    return int(np.prod(input_shape)), int(np.prod(output_shape))


def generate_diagonal(shape, mode: str, generator=None, dtype=torch.float32) -> torch.Tensor:
    """A random diagonal (structured_random.py:28) from ``generator``:
    ``"rademacher"`` signs or ``"uniform_phase"`` unit complex numbers."""
    if mode == "rademacher":
        return (torch.rand(tuple(shape), generator=generator) < 0.5).to(dtype) * 2 - 1
    if mode == "uniform_phase":
        phase = torch.rand(tuple(shape), generator=generator) * (2 * math.pi)
        return torch.polar(torch.ones_like(phase), phase)
    raise ValueError(mode)


class StructuredRandom(LinearPhysics):
    r"""``y = crop(prod_i F D_i x)`` (structured_random.py:38).

    :param input_shape: ``(C, H, W)``.
    :param output_shape: ``(C, H', W')``, at most the input's (a centred
        crop); the input's by default.
    :param n_layers: the (transform, diagonal) layers; a half more means a
        last transform without a diagonal (the reference's convention).
    :param diagonal_mode: ``"rademacher"`` or ``"uniform_phase"``.
    :param diagonals: the ``int(n_layers)`` diagonals of ``input_shape``;
        drawn from ``generator`` (seeded from ``seed`` if None) where None.
    :param device: where the diagonals live; the CUDA device by default.
    """

    def __init__(self, input_shape, output_shape=None, n_layers: float = 1.0,
                 transform: str = "dst1", diagonal_mode: str = "rademacher", diagonals=None,
                 generator=None, seed: int = 0, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(output_shape) if output_shape is not None else self.input_shape
        self.n_layers = n_layers
        n_diag = int(n_layers)
        if diagonals is None:
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            diagonals = [generate_diagonal(self.input_shape, diagonal_mode, generator)
                         for _ in range(n_diag)]
        self._n_diag = len(diagonals)
        for i, d in enumerate(diagonals):
            self.register_buffer(f"diagonal_{i}", torch.as_tensor(d))
        self.extra_transform = (n_layers - n_diag) > 0.0
        self.to(device)

    @property
    def diagonals(self) -> list:
        return [getattr(self, f"diagonal_{i}") for i in range(self._n_diag)]

    def _transform(self, x):
        return dst1(x, axes=(-2, -1))

    def A(self, x, **params):
        out = self._transform(x) if self.extra_transform else x
        for d in self.diagonals:
            out = self._transform(out * d)
        H, W = out.shape[-2:]
        h, w = self.output_shape[-2:]
        top, left = (H - h) // 2, (W - w) // 2
        return out[..., top:top + h, left:left + w]

    def A_adjoint(self, y, **params):
        return linear_transpose(self.A, y, (y.shape[0],) + self.input_shape)

"""Noise models (port of deepinv_tpu/physics/noise.py).

Randomness is a ``torch.Generator`` passed as ``generator=``, in place of the
JAX package's ``key=``. With ``generator=None`` a generator seeded from the
model's ``seed`` is used, so a draw is reproducible like the JAX package's
``ensure_key(key, seed)`` (noise.py:59). The two frameworks draw different
numbers from the same seed: tests pass the noise in explicitly.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .base import update

__all__ = ["NoiseModel", "GaussianNoise"]


def _bcast(param: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or (B,)-shaped parameter over x's trailing dims
    (noise.py:42)."""
    if param.dim() == 0:
        return param
    return param.reshape(param.shape + (1,) * (x.dim() - param.dim()))


class NoiseModel(nn.Module):
    """Base noise model (deepinv_tpu/physics/noise.py:50): identity."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.seed = seed

    def sample(self, y, generator):
        return y

    def forward(self, y, generator=None):
        if generator is None:
            generator = torch.Generator(device=y.device).manual_seed(self.seed)
        return self.sample(y, generator)

    def update(self, **params):
        """Return a copy with the known parameters replaced
        (:func:`deepinv_tpu_torch.physics.base.update`)."""
        return update(self, **params)


class GaussianNoise(NoiseModel):
    r"""``y = x + sigma * eps``, eps ~ N(0, I) (noise.py:112).

    ``sigma`` is a scalar or a ``(B,)`` tensor of per-sample levels, kept as a
    buffer on ``device`` (the CUDA device by default). Complex measurements
    get circular complex noise.
    """

    def __init__(self, sigma=0.1, seed: int = 0, device=None):
        super().__init__(seed=seed)
        self.register_buffer("sigma", torch.as_tensor(sigma, dtype=torch.float32).to(
            resolve_device(device)))

    def sample(self, y, generator):
        s = _bcast(self.sigma, y)
        if y.is_complex():
            rdt = y.real.dtype
            eps = torch.complex(
                torch.randn(y.shape, generator=generator, device=y.device, dtype=rdt),
                torch.randn(y.shape, generator=generator, device=y.device, dtype=rdt))
        else:
            eps = torch.randn(y.shape, generator=generator, device=y.device, dtype=y.dtype)
        return y + s * eps

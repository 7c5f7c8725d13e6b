"""Mixed-precision inference wrapper (port of deepinv_tpu/models/precision.py).

On the H100 as on the TPU, bf16 activations with f32 accumulation halve the
activation traffic and run the convolutions on the tensor cores; through a
PnP prox step the reconstruction stays within 0.1 dB of f32
(tests/test_models.py::test_autocast_bf16_parity).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .base import Denoiser

__all__ = ["AutocastDenoiser", "autocast"]


class AutocastDenoiser(Denoiser):
    """Run ``denoiser`` on inputs cast to ``dtype``, cast the output back
    (deepinv_tpu/models/precision.py:23).

    :param denoiser: any ``denoiser(x, sigma)`` module.
    :param dtype: compute dtype (default bfloat16).
    :param cast_params: store a copy of the denoiser with its float32
        parameters in ``dtype`` (default), so no iteration re-casts them; the
        module passed in is left as it was. ``False`` wraps it as it is.
    """

    def __init__(self, denoiser: nn.Module, dtype=torch.bfloat16, cast_params: bool = True):
        super().__init__()
        if cast_params:
            denoiser = copy.deepcopy(denoiser)
            for t in list(denoiser.parameters()) + list(denoiser.buffers()):
                if t.dtype == torch.float32:
                    t.data = t.data.to(dtype)
        self.denoiser = denoiser
        self.dtype = dtype

    def forward(self, x, sigma=None, **kwargs):
        return self.denoiser(x.to(self.dtype), sigma, **kwargs).to(x.dtype)


def autocast(denoiser: nn.Module, dtype=torch.bfloat16, cast_params: bool = True) -> AutocastDenoiser:
    """Wrap a denoiser for bf16 compute (precision.py:65)."""
    return AutocastDenoiser(denoiser, dtype=dtype, cast_params=cast_params)

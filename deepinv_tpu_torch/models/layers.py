"""Network layers DRUNet needs (port of deepinv_tpu/models/layers.py).

Weights keep the torch layout the JAX package already uses (OIHW, IOHW for
transposed convs), and its He-normal initialization from an explicit
``torch.Generator``. The precision policy is ``CONV_ACCUM="native"``
(layers.py:45-50): a conv runs in the activation dtype, so bf16 activations
give bf16 outputs with f32 accumulation and one rounding per conv. As in the
JAX package, weights are cast to the activation dtype at the call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "ConvTranspose2d", "Sequential", "he_init"]


def he_init(shape, fan_in: int, generator=None) -> torch.Tensor:
    """Kaiming-normal (fan-in) weights (layers.py:57)."""
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


class Conv2d(nn.Conv2d):
    """Bias-free-capable 2D conv, NCHW / OIHW (layers.py:63)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        with torch.no_grad():
            self.weight.copy_(he_init(self.weight.shape, in_channels * kernel_size ** 2,
                                      generator))
            if self.bias is not None:
                self.bias.zero_()

    def reset_parameters(self):
        """Initialization happens in ``__init__`` from the caller's generator."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """2D transposed conv with torch semantics, IOHW weights (layers.py:118)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, padding: int = 0, bias: bool = True, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        with torch.no_grad():
            self.weight.copy_(he_init(self.weight.shape, in_channels * kernel_size ** 2,
                                      generator))
            if self.bias is not None:
                self.bias.zero_()

    def reset_parameters(self):
        """Initialization happens in ``__init__`` from the caller's generator."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Sequential(nn.Module):
    """Layers applied in order (layers.py:188). They live in ``layers`` so
    parameter names match the JAX module's tree paths
    (``m_down1.layers.0.conv1.weight``)."""

    def __init__(self, *layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def __getitem__(self, i):
        return self.layers[i]

    def __len__(self):
        return len(self.layers)

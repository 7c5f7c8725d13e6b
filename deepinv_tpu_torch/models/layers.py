"""Network layers (port of deepinv_tpu/models/layers.py).

Weights keep the torch layout the JAX package already uses (OIHW / OIDHW,
IOHW / IODHW for transposed convs, ``(out, in)`` for linear layers), and its
initializations from an explicit ``torch.Generator``: He-normal for convs,
uniform in ``+-1/sqrt(in)`` for linear layers, zero biases. The precision
policy is ``CONV_ACCUM="native"`` (layers.py:45-50): a conv runs in the
activation dtype, so bf16 activations give bf16 outputs with f32
accumulation and one rounding per conv. As in the JAX package, weights are
cast to the activation dtype at the call.

Every array leaf of a JAX module is a trainable leaf of its ``Trainer``
(deepinv_tpu/core/module.py:172), so every tensor here is an
``nn.Parameter``: :class:`BatchNorm2d`'s running statistics too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "ConvTranspose2d", "Conv3d", "ConvTranspose3d", "Linear", "Sequential",
           "ReLU", "LeakyReLU", "GELU", "Identity", "AvgPool2d", "MaxPool2d", "MaxPool3d",
           "UpsampleNearest", "PixelShuffle", "BatchNorm2d", "he_init", "fix_dim", "conv_nd",
           "conv_transpose_nd", "memory_format"]


def he_init(shape, fan_in: int, generator=None) -> torch.Tensor:
    """Kaiming-normal (fan-in) weights (layers.py:57)."""
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


def _init(module, fan_in: int, generator):
    with torch.no_grad():
        module.weight.copy_(he_init(module.weight.shape, fan_in, generator))
        if module.bias is not None:
            module.bias.zero_()


class Conv2d(nn.Conv2d):
    """2D conv, NCHW / OIHW (layers.py:63)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True, groups: int = 1,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias,
                         groups=groups)
        _init(self, in_channels // groups * kernel_size ** 2, generator)

    def reset_parameters(self):
        """Initialization happens in ``__init__`` from the caller's generator."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding, 1, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """2D transposed conv with torch semantics, IOHW weights (layers.py:118)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, padding: int = 0, bias: bool = True, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        _init(self, in_channels * kernel_size ** 2, generator)

    def reset_parameters(self):
        """Initialization happens in ``__init__`` from the caller's generator."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Conv3d(nn.Conv3d):
    """3D conv, NCDHW / OIDHW (layers.py:238)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True, groups: int = 1,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias,
                         groups=groups)
        _init(self, in_channels // groups * kernel_size ** 3, generator)

    def reset_parameters(self):
        """Initialization happens in ``__init__`` from the caller's generator."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv3d(x, self.weight.to(x.dtype), b, self.stride, self.padding, 1, self.groups)


class ConvTranspose3d(nn.ConvTranspose3d):
    """3D transposed conv with torch semantics, IODHW weights (layers.py:278)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, padding: int = 0, bias: bool = True, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        _init(self, in_channels * kernel_size ** 3, generator)

    def reset_parameters(self):
        """Initialization happens in ``__init__`` from the caller's generator."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose3d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Linear(nn.Linear):
    """``x W^T + b`` (layers.py:172): weights uniform in ``+-1/sqrt(in)``,
    zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, generator=None):
        super().__init__(in_features, out_features, bias=bias)
        bound = 1 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.copy_(torch.rand(self.weight.shape, generator=generator) * 2 * bound
                              - bound)
            if self.bias is not None:
                self.bias.zero_()

    def reset_parameters(self):
        """Initialization happens in ``__init__`` from the caller's generator."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Sequential(nn.Module):
    """Layers applied in order (layers.py:188). They live in ``layers`` so
    parameter names match the JAX module's tree paths
    (``m_down1.layers.0.conv1.weight``)."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def __getitem__(self, i):
        return self.layers[i]

    def __len__(self):
        return len(self.layers)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class GELU(nn.Module):
    """``jax.nn.gelu``'s default, the tanh approximation (layers.py:222)."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")


class Identity(nn.Module):
    def forward(self, x):
        return x


class _Pool(nn.Module):
    def __init__(self, kernel_size: int = 2, stride: Optional[int] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size


class AvgPool2d(_Pool):
    """Mean over ``k x k`` windows, no padding (layers.py:349)."""

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride)


class MaxPool2d(_Pool):
    """Max over ``k x k`` windows, no padding (layers.py:362)."""

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride)


class MaxPool3d(_Pool):
    """Max over ``k^3`` windows, no padding (layers.py:319)."""

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride)


class UpsampleNearest(nn.Module):
    """Each pixel repeated ``factor`` times along H and W (layers.py:374)."""

    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        f = self.factor
        return x.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1)


class PixelShuffle(nn.Module):
    """``(B, C r^2, H, W) -> (B, C, H r, W r)`` (layers.py:383), torch's order."""

    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor)


class BatchNorm2d(nn.Module):
    """Inference-mode batch norm with the running statistics at every call
    (layers.py:395), for 4D and 5D inputs. Not ``nn.BatchNorm2d``: a module
    in training mode would normalise by the batch's statistics. The four
    tensors are parameters, as the JAX ``Trainer`` differentiates all four
    leaves."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.running_mean = nn.Parameter(torch.zeros(num_features))
        self.running_var = nn.Parameter(torch.ones(num_features))
        self.eps = eps

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        m, v = self.running_mean.reshape(shape), self.running_var.reshape(shape)
        return (x - m) / torch.sqrt(v + self.eps) * self.weight.reshape(shape) \
            + self.bias.reshape(shape)


def fix_dim(dim) -> int:
    """``dim`` as 2 or 3: 2 / 3 / "2" / "2d" / "3D" (layers.py:331)."""
    d = int(str(dim).lower().rstrip("d"))
    if d not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim!r}")
    return d


def conv_nd(dim):
    """The conv class of ``dim`` spatial dimensions (layers.py:340)."""
    return Conv2d if fix_dim(dim) == 2 else Conv3d


def conv_transpose_nd(dim):
    """The transposed-conv class of ``dim`` spatial dimensions (layers.py:345)."""
    return ConvTranspose2d if fix_dim(dim) == 2 else ConvTranspose3d


def memory_format(dim) -> torch.memory_format:
    """cuDNN's channels-last layout for ``dim`` spatial dimensions (new in the
    port): ``torch.channels_last`` takes 4D tensors only."""
    return torch.channels_last if fix_dim(dim) == 2 else torch.channels_last_3d

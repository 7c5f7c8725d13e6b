"""UNet denoiser / reconstructor backbone (port of deepinv_tpu/models/unet.py),
2D or 3D."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import Denoiser
from .layers import BatchNorm2d, MaxPool2d, MaxPool3d, conv_nd, conv_transpose_nd, fix_dim
from .utils import test_pad

__all__ = ["UNet"]


class _DoubleConv(nn.Module):
    """conv - (norm) - ReLU - conv - (norm) - ReLU (unet.py:16); the convs
    carry a bias only without the inference-mode norms."""

    def __init__(self, cin: int, cout: int, batch_norm: bool = True, dim=2, generator=None):
        super().__init__()
        Conv = conv_nd(dim)
        self.conv1 = Conv(cin, cout, 3, 1, 1, bias=not batch_norm, generator=generator)
        self.conv2 = Conv(cout, cout, 3, 1, 1, bias=not batch_norm, generator=generator)
        self.bn1 = BatchNorm2d(cout) if batch_norm else None
        self.bn2 = BatchNorm2d(cout) if batch_norm else None

    def forward(self, x):
        x = self.conv1(x)
        if self.bn1 is not None:
            x = self.bn1(x)
        x = self.conv2(F.relu(x))
        if self.bn2 is not None:
            x = self.bn2(x)
        return F.relu(x)


class UNet(Denoiser):
    """``scales``-scale UNet with concatenated skips (unet.py:38).

    :param base: the first scale's width; each scale doubles it.
    :param residual: add the input to the output where their shapes agree.
    :param batch_norm: inference-mode norms after each conv.
    :param dim: 2 or 3 spatial dimensions.
    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, scales: int = 4,
                 base: int = 64, residual: bool = True, batch_norm: bool = True, dim=2,
                 generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.scales = scales
        self.residual = residual
        self.dim = dim = fix_dim(dim)
        chans = [base * 2 ** i for i in range(scales)]
        self.inc = _DoubleConv(in_channels, chans[0], batch_norm, dim, g)
        self.down = nn.ModuleList([_DoubleConv(chans[i], chans[i + 1], batch_norm, dim, g)
                                   for i in range(scales - 1)])
        self.pool = MaxPool2d(2) if dim == 2 else MaxPool3d(2)
        ConvT = conv_transpose_nd(dim)
        self.upconv = nn.ModuleList([ConvT(chans[i + 1], chans[i], 2, 2, generator=g)
                                     for i in reversed(range(scales - 1))])
        self.up = nn.ModuleList([_DoubleConv(chans[i] * 2, chans[i], batch_norm, dim, g)
                                 for i in reversed(range(scales - 1))])
        self.outc = conv_nd(dim)(chans[0], out_channels, 1, 1, 0, generator=g)
        self.to(device)

    def _forward(self, x):
        feats = [self.inc(x)]
        for d in self.down:
            feats.append(d(self.pool(feats[-1])))
        h = feats[-1]
        for up_conv, dc, skip in zip(self.upconv, self.up, reversed(feats[:-1])):
            h = dc(torch.cat([skip, up_conv(h)], dim=1))
        return self.outc(h)

    def forward(self, x, sigma=None, **kwargs):
        mod = 2 ** (self.scales - 1)
        if all(s % mod == 0 for s in x.shape[2:]):
            out = self._forward(x)
        else:
            out = test_pad(self._forward, x, modulo=mod)
        return out + x if self.residual and out.shape == x.shape else out

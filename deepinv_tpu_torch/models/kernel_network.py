"""The space-varying blur kernel estimator of Carbajal et al. (J-MKPD; port of
deepinv_tpu/models/kernel_network.py).

A UNet with two heads: the mask head gives each pixel its weights over K
kernels (a softmax over K), and the kernel head pools the encoder's features
globally and decodes them into K blur kernels (a softmax over each kernel's
pixels). Its output plugs into
:class:`~deepinv_tpu_torch.physics.SpaceVaryingBlur` by
``physics.update(**out)``; the published checkpoint loads by
:func:`~deepinv_tpu_torch.models.convert.port_kernel_network`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv2d, ConvTranspose2d, MaxPool2d
from .utils import resize_bilinear

__all__ = ["KernelIdentificationNetwork"]


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


class _Down(nn.Module):
    """Two 3x3 convs, then a 2x2 max pool (kernel_network.py:30)."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, 1, 1, generator=generator)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, generator=generator)
        self.pool = MaxPool2d(2)

    def forward(self, x):
        feat = _lrelu(self.conv2(_lrelu(self.conv1(x))))
        return feat, self.pool(feat)


class _Up(nn.Module):
    """Upscale, two 3x3 convs, the skip concatenated, a fusing conv
    (kernel_network.py:44). The bilinear branch resizes as the JAX one does,
    ``jax.image.resize``'s half-pixel centres (``models/utils.py``
    ``resize_bilinear``), although its comment names
    ``align_corners=True`` (kernel_network.py:58-60; ROADMAP queue 3)."""

    def __init__(self, cin, feat_channels, cout, bilinear=False, generator=None):
        super().__init__()
        g = generator
        self.bilinear = bilinear
        if not bilinear:
            self.up = ConvTranspose2d(cin, cin, 2, 2, 0, generator=g)
        self.conv1 = Conv2d(cin, cout, 3, 1, 1, generator=g)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, generator=g)
        self.feat = Conv2d(feat_channels + cout, cout, 3, 1, 1, generator=g)

    def forward(self, x1, x2=None):
        if self.bilinear:
            x1 = resize_bilinear(x1, (2 * x1.shape[2], 2 * x1.shape[3]))
        else:
            x1 = self.up(x1)
        x1 = _lrelu(self.conv2(_lrelu(self.conv1(x1))))
        if x2 is not None:
            dY, dX = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
            if dY or dX:
                x1 = F.pad(x1, (dX // 2, dX - dX // 2, dY // 2, dY - dY // 2))
            x1 = torch.cat([x2, x1], 1)
        return _lrelu(self.feat(x1))


def _pooled_skip(x, size):
    """The global average broadcast to ``size x size`` (kernel_network.py:77)."""
    gap = x.mean((2, 3), keepdim=True)
    return gap.expand(gap.shape[:2] + (size, size))


class KernelIdentificationNetwork(nn.Module):
    """Blind space-varying kernel estimator (kernel_network.py:83).
    ``model(y)`` returns ``{"filters": (N, 1, K, s, s), "multipliers": (N, 1,
    K, H, W)}`` for ``SpaceVaryingBlur``; inputs in [0, 1], not gamma
    corrected.

    :param filters: the number K of kernels.
    :param blur_kernel_size: 33 or 65.
    :param bilinear: bilinear upsampling in place of transposed convs.
    :param no_softmax: leaky-ReLU kernels in place of the pixel softmax.
    :param pretrained: path of the published checkpoint.
    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, filters: int = 25, blur_kernel_size: int = 33, bilinear: bool = False,
                 no_softmax: bool = False, pretrained=None, generator=None, device=None):
        if blur_kernel_size not in (33, 65):
            raise ValueError("blur_kernel_size must be 33 or 65")
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.K = filters
        self.blur_kernel_size = blur_kernel_size
        self.no_softmax = no_softmax
        self.inc_rgb = Conv2d(3, 64, 3, 1, 1, generator=g)
        self.inc_gray = Conv2d(1, 64, 3, 1, 1, generator=g)
        self.down1 = _Down(64, 64, g)
        self.down2 = _Down(64, 128, g)
        self.down3 = _Down(128, 256, g)
        self.down4 = _Down(256, 512, g)
        self.down5 = _Down(512, 1024, g)
        self.feat = Conv2d(1024, 1024, 3, 1, 1, generator=g)
        self.up1 = _Up(1024, 1024, 512, bilinear, g)
        self.up2 = _Up(512, 512, 256, bilinear, g)
        self.up3 = _Up(256, 256, 128, bilinear, g)
        self.up4 = _Up(128, 128, 64, bilinear, g)
        self.up5 = _Up(64, 64, 64, bilinear, g)
        self.masks_end = nn.ModuleList([Conv2d(64, 64, 3, 1, 1, generator=g),
                                        Conv2d(64, 64, 3, 1, 1, generator=g),
                                        Conv2d(64, self.K, 3, 1, 1, generator=g)])
        self.kernel_up1 = _Up(1024, 1024, 512, bilinear, g)
        self.kernel_up2 = _Up(512, 512, 256, bilinear, g)
        self.kernel_up3 = _Up(256, 256, 256, bilinear, g)
        self.kernel_up4 = _Up(256, 128, 128, bilinear, g)
        self.kernel_up5 = _Up(128, 64, 64, bilinear, g)
        if blur_kernel_size > 33:
            self.kernel_up6 = _Up(64, 0, 64, bilinear, g)
        # the first conv's even 2x2 kernel with padding 1 turns 32 into 33
        # (kernel_network.py:135)
        self.kernels_end = nn.ModuleList([Conv2d(64, 64, 2, 1, 1, generator=g),
                                          Conv2d(64, 64, 3, 1, 1, generator=g),
                                          Conv2d(64, self.K, 3, 1, 1, generator=g)])
        if pretrained is not None:
            from .convert import load_torch_checkpoint, port_kernel_network

            port_kernel_network(self, load_torch_checkpoint(pretrained))
        self.to(device)

    @staticmethod
    def _head(convs, h):
        h = convs[0](h)
        h = convs[1](_lrelu(h))
        return convs[2](_lrelu(h))

    def forward(self, x, **kwargs):
        x = x - 0.5
        x1 = _lrelu(self.inc_rgb(x) if x.shape[1] == 3 else self.inc_gray(x))
        x1_feat, x2 = self.down1(x1)
        x2_feat, x3 = self.down2(x2)
        x3_feat, x4 = self.down3(x3)
        x4_feat, x5 = self.down4(x4)
        x5_feat, x6 = self.down5(x5)
        x6_feat = _lrelu(self.feat(x6))

        k = self.kernel_up1(x6_feat.mean((2, 3), keepdim=True), _pooled_skip(x5_feat, 2))
        k = self.kernel_up2(k, _pooled_skip(x4_feat, 4))
        k = self.kernel_up3(k, _pooled_skip(x3_feat, 8))
        k = self.kernel_up4(k, _pooled_skip(x2_feat, 16))
        k = self.kernel_up5(k, _pooled_skip(x1_feat, 32))
        if self.blur_kernel_size == 65:
            k = self.kernel_up6(k)
        k = self._head(self.kernels_end, k)
        N, s = k.shape[0], self.blur_kernel_size
        k = k.reshape(N, self.K, s * s)
        k = F.leaky_relu(k, 0.01) if self.no_softmax else torch.softmax(k, 2)
        k = k.reshape(N, self.K, s, s)

        m = self.up1(x6_feat, x5_feat)
        m = self.up2(m, x4_feat)
        m = self.up3(m, x3_feat)
        m = self.up4(m, x2_feat)
        m = self.up5(m, x1_feat)
        m = torch.softmax(self._head(self.masks_end, m), 1)
        # the correlation kernels in convolution orientation (kernel_network.py:184)
        return {"filters": torch.flip(k, (2, 3))[:, None], "multipliers": m[:, None]}

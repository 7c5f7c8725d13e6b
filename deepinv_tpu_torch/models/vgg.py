"""VGG16 feature extractor in torchvision's ``vgg16().features`` layout (port
of deepinv_tpu/models/vgg.py), the backbone of ``LPIPS``.

``VGG16Features(x)`` returns the five ReLU feature maps LPIPS taps: relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3. A torchvision ``vgg16`` state dict
(``features.<idx>.weight``) loads by :func:`port_vgg16` (vgg.py:80; kept in
``convert.py`` with the other name maps and re-exported here, as JAX exports
it from this module).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .convert import load_torch_checkpoint, port_vgg16
from .layers import Conv2d, MaxPool2d

__all__ = ["VGG16Features", "port_vgg16"]

# torchvision's VGG16 configuration 'D': channels of each conv, 'M' a max pool
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
        512, 512, 512, "M"]
# each conv's index in torchvision's nn.Sequential, ReLUs and pools included (vgg.py:27)
_TORCH_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
# the conv (0-based, after its ReLU) that ends each LPIPS stage (vgg.py:29)
_STAGE_END = [1, 3, 6, 9, 12]
# the convs a 2x2 max pool follows (vgg.py:75); the last pool, after conv 12,
# lies past every tap
_POOL_AFTER = (1, 3, 6, 9)


class VGG16Features(nn.Module):
    """VGG16's convolutional trunk returning the five LPIPS stages
    (vgg.py:32).

    :param pretrained: path of a torchvision ``vgg16`` state dict to load;
        None keeps the random initialization.
    :param requires_input_norm: normalize inputs in [0, 1] by the ImageNet
        mean and deviation (cast to the input's dtype) before the first conv.
    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, pretrained=None, requires_input_norm: bool = True, generator=None,
                 device=None):
        device = resolve_device(device)
        super().__init__()
        convs, cin = [], 3
        for c in _CFG:
            if c != "M":
                convs.append(Conv2d(cin, c, 3, 1, 1, bias=True, generator=generator))
                cin = c
        self.convs = nn.ModuleList(convs)
        self.pool = MaxPool2d(2)
        self.requires_input_norm = requires_input_norm
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]).reshape(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]).reshape(1, 3, 1, 1))
        if pretrained is not None:
            port_vgg16(self, load_torch_checkpoint(pretrained))
        self.to(device)

    def forward(self, x):
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        if self.requires_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        feats = []
        h = x
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            if i in _STAGE_END:
                feats.append(h)
            if i in _POOL_AFTER:
                h = self.pool(h)
        return feats


"""DnCNN denoiser (port of deepinv_tpu/models/dncnn.py).

``depth`` 3x3 convs at ``nf`` channels with ReLU between them and a residual
output ``out_conv(h) + x`` (dncnn.py:59-62), no batch norm. Attribute names
match the JAX module (``in_conv``, ``conv_list.{i}``, ``out_conv``), so its
weights load by name (:func:`~deepinv_tpu_torch.models.convert.load_jax_params`).

The ``depth - 2`` hidden layers run through the hand-written kernel op
:func:`~deepinv_tpu_torch.ops.kernels.conv_chain.conv_chain` when the
activations are bf16, ``nf`` is 64, every hidden conv has a bias and there are
at least two of them, ``fused`` is True and no ``fused_chains_disabled()``
context is active: the JAX gate (dncnn.py:72-77, ``can_fuse_chain``
conv_chain.py:227-245) without its TPU-only conditions (even W from the
pixel-pair fold, H >= 8 and the VMEM budget). Under autograd the op's
forward is the stash kernel (K6) and its backward reads the stash; under
``torch.no_grad()`` it is the inference kernel (K5). Everything else is plain
``torch.nn.functional``. ``pretrained`` weights and 3D wait for ROADMAP
queue 1 item 8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.kernels.conv_chain import C as CHAIN_C
from ..ops.kernels.conv_chain import conv_chain, fused_disabled, pack_bias, pack_weights
from .base import Denoiser
from .layers import Conv2d
from .utils import stacked_weights

__all__ = ["DnCNN"]


class DnCNN(Denoiser):
    """DnCNN (deepinv_tpu/models/dncnn.py:19).

    :param in_channels: image channels.
    :param out_channels: output channels (equal to ``in_channels`` for the
        residual output).
    :param depth: number of conv layers.
    :param bias: convs with a bias.
    :param nf: hidden width.
    :param generator: CPU ``torch.Generator`` for the He-normal
        initialization (biases start at zero, as in the JAX package).
    :param device: where the weights are moved after they are drawn on the
        CPU; the CUDA device by default.
    :param fused: run the hidden chain through the kernel op where it
        applies (the JAX ``DEEPINV_TPU_FUSED_DNCNN``, conv_chain.py:235, which
        is on by default); ``False`` takes the layers.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, depth: int = 20,
                 bias: bool = True, nf: int = 64, pretrained=None, dim: int = 2,
                 generator=None, device=None, fused: bool = True):
        device = resolve_device(device)
        super().__init__()
        if pretrained is not None or dim != 2:
            raise NotImplementedError(
                "pretrained DnCNN weights and 3D DnCNN wait for ROADMAP queue 1 item 8")
        g = generator
        self.depth = depth
        self.fused = fused
        self.in_conv = Conv2d(in_channels, nf, 3, 1, 1, bias=bias, generator=g)
        self.conv_list = nn.ModuleList(
            [Conv2d(nf, nf, 3, 1, 1, bias=bias, generator=g) for _ in range(depth - 2)])
        self.out_conv = Conv2d(nf, out_channels, 3, 1, 1, bias=bias, generator=g)
        # channels_last is cuDNN's layout for bf16 convs on the H100 and the
        # kernel's (see drunet.py): weights and activations stay in it
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x, sigma=None, **kwargs):
        # channels_last strides even at one channel, where
        # x.contiguous(memory_format=...) keeps the NCHW strides and cuDNN
        # then transposes around in_conv and returns NCHW
        xc = torch.empty_like(x, memory_format=torch.channels_last).copy_(x)
        h = F.relu(self.in_conv(xc))
        h = self._hidden_chain(h)
        return self.out_conv(h) + x

    def _hidden_chain(self, h):
        """The ``nf``-channel conv + ReLU chain: the kernel op where it
        applies (dncnn.py:64-83), the layers one by one otherwise."""
        convs = self.conv_list
        if (self.fused and not fused_disabled() and h.dtype == torch.bfloat16
                and h.shape[1] == CHAIN_C and len(convs) >= 2
                and all(c.bias is not None for c in convs)):
            ws, bs, packed = stacked_weights(
                self, ([c.weight for c in convs], [c.bias for c in convs]),
                lambda w, b: (pack_weights(w), pack_bias(b)))
            return conv_chain(h, ws, bs, packed)
        for conv in convs:
            h = F.relu(conv(h))
        return h

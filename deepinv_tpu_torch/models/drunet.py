"""DRUNet sigma-conditioned denoiser (port of deepinv_tpu/models/drunet.py).

Head conv -> 3 x [nb ResBlocks + strided 2x2 conv down] -> nb-ResBlock body
-> 3 x [2x2 transposed conv up + nb ResBlocks] -> tail conv, bias-free, with
additive long skips (drunet.py:158-171). The noise level enters as an extra
input channel. Attribute names match the JAX module, so its weights load by
name (:func:`~deepinv_tpu_torch.models.convert.load_jax_params`).

Scale 0's down chain ``m_down1[:-1]`` runs through the hand-written kernel op
:func:`~deepinv_tpu_torch.ops.kernels.resblock_chain.resblock_chain` when its
activations are bf16 at 64 channels and its blocks are ReLU and bias-free —
the set the JAX package fuses by default (drunet_fold.py:160-198,
resblock_chain.py:154-171). Every other conv is plain ``torch.nn.functional``.
The JAX package's W-folded forward (drunet_fold.py) is a TPU lane-layout
permutation of the same math and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.kernels.resblock_chain import C as CHAIN_C
from ..ops.kernels.resblock_chain import pack_weights, resblock_chain
from .base import Denoiser, handle_sigma
from .layers import Conv2d, ConvTranspose2d, Sequential
from .utils import stacked_weights, test_pad

__all__ = ["DRUNet", "ResBlock"]

_ACTS = {
    "R": F.relu,
    "L": lambda x: F.leaky_relu(x, 1e-2),
    "E": F.elu,
    "S": F.softplus,
    "s": F.softplus,
}


class ResBlock(torch.nn.Module):
    """``x + conv2(act(conv1(x)))`` (deepinv_tpu/models/drunet.py:56), with
    the reference's 0.2 init gain (drunet.py:69-72)."""

    def __init__(self, nc: int, bias: bool = False, act_mode: str = "R", generator=None):
        super().__init__()
        self.conv1 = Conv2d(nc, nc, 3, 1, 1, bias=bias, generator=generator)
        self.conv2 = Conv2d(nc, nc, 3, 1, 1, bias=bias, generator=generator)
        self.act_mode = act_mode
        with torch.no_grad():
            self.conv1.weight.mul_(0.2)
            self.conv2.weight.mul_(0.2)

    def forward(self, x):
        return x + self.conv2(_ACTS[self.act_mode](self.conv1(x)))


class DRUNet(Denoiser):
    """Sigma-conditioned UNet-ResNet denoiser (deepinv_tpu/models/drunet.py:78).

    :param in_channels: image channels (the noise map is one more).
    :param out_channels: output channels.
    :param nc: widths of the four scales.
    :param nb: residual blocks per stage.
    :param act_mode: R (ReLU), L, E or S.
    :param generator: CPU ``torch.Generator`` for the random initialization.
    :param device: where the weights are moved after they are drawn on the
        CPU; the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, nc=(64, 128, 256, 512),
                 nb: int = 4, act_mode: str = "R", generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        nc = tuple(nc)
        self.nb = nb
        g = generator
        self.m_head = Conv2d(in_channels + 1, nc[0], 3, 1, 1, bias=False, generator=g)

        def down_stage(cin, cout):
            blocks = [ResBlock(cin, act_mode=act_mode, generator=g) for _ in range(nb)]
            return Sequential(*blocks, Conv2d(cin, cout, 2, 2, 0, bias=False, generator=g))

        def up_stage(cin, cout):
            up = ConvTranspose2d(cin, cout, 2, 2, 0, bias=False, generator=g)
            return Sequential(up, *[ResBlock(cout, act_mode=act_mode, generator=g)
                                    for _ in range(nb)])

        self.m_down1 = down_stage(nc[0], nc[1])
        self.m_down2 = down_stage(nc[1], nc[2])
        self.m_down3 = down_stage(nc[2], nc[3])
        self.m_body = Sequential(*[ResBlock(nc[3], act_mode=act_mode, generator=g)
                                   for _ in range(nb)])
        self.m_up3 = up_stage(nc[3], nc[2])
        self.m_up2 = up_stage(nc[2], nc[1])
        self.m_up1 = up_stage(nc[1], nc[0])
        self.m_tail = Conv2d(nc[0], out_channels, 3, 1, 1, bias=False, generator=g)
        # channels_last is cuDNN's native layout for bf16 tensor-core convs on
        # the H100 and the resblock-chain kernel's: on NCHW activations cuDNN
        # transposes around every conv, on NCHW weights with NHWC activations
        # it converts the weight each call (measured on an H100: PERF.md).
        self.to(device=device, memory_format=torch.channels_last)

    def _chain_weights(self, blocks):
        """Stacked OIHW weights of the scale-0 chain and their kernel
        packing, packed once per weight version (:func:`stacked_weights`)."""
        return stacked_weights(
            self, ([b.conv1.weight for b in blocks], [b.conv2.weight for b in blocks]),
            lambda w1s, w2s: (pack_weights(w1s), pack_weights(w2s)))

    def _down_chain0(self, x):
        """Scale-0 down chain ``m_down1[:-1]``: the kernel op where it
        applies, the blocks one by one otherwise."""
        blocks = list(self.m_down1[:-1])
        if (x.dtype == torch.bfloat16 and x.shape[1] == CHAIN_C and blocks
                and all(b.act_mode == "R" and b.conv1.bias is None and b.conv2.bias is None
                        for b in blocks)):
            w1s, w2s, packed = self._chain_weights(blocks)
            return resblock_chain(x, w1s, w2s, packed)
        for b in blocks:
            x = b(x)
        return x

    def forward_unet(self, x0):
        """UNet on the image + noise-map input (drunet.py:163-171)."""
        x1 = self.m_head(x0.contiguous(memory_format=torch.channels_last))
        x2 = self.m_down1[-1](self._down_chain0(x1))
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        x = self.m_body(x4)
        x = self.m_up3(x + x4)
        x = self.m_up2(x + x3)
        x = self.m_up1(x + x2)
        return self.m_tail(x + x1)

    def forward(self, x, sigma=0.05, **kwargs):
        xin = torch.cat([x, handle_sigma(sigma, x)], dim=1)
        if all(s % 8 == 0 and s > 31 for s in x.shape[2:]):
            return self.forward_unet(xin)
        return test_pad(self.forward_unet, xin, modulo=16)

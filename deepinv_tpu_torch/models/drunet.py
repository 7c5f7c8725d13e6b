"""DRUNet sigma-conditioned denoiser (port of deepinv_tpu/models/drunet.py).

Head conv -> 3 x [nb ResBlocks + strided 2x2 conv down] -> nb-ResBlock body
-> 3 x [2x2 transposed conv up + nb ResBlocks] -> tail conv, bias-free, with
additive long skips (drunet.py:158-171). The noise level enters as an extra
input channel. Attribute names match the JAX module, so its weights load by
name (:func:`~deepinv_tpu_torch.models.convert.load_jax_params`).

The ``fused`` argument picks which stages run through the port's
hand-written kernel ops, with the values and semantics of the JAX package's
``DEEPINV_TPU_FUSED_DRUNET`` (drunet_fold.py:160-178, 192, 215, 260):

- ``"down"`` (default): scale 0's down chain ``m_down1[:-1]`` through
  :func:`~deepinv_tpu_torch.ops.kernels.resblock_chain.resblock_chain` (K1);
- ``"up"``: only the scale-0 up stage ``m_up1`` through
  :func:`~deepinv_tpu_torch.ops.kernels.up_resblock_chain.up_resblock_chain`
  (K2/K3); the down chain then runs block by block;
- ``"both"`` (or ``"1"``): the two;
- ``"sandwich"``: the down chain, and the whole up tail ``m_up2`` + ``m_up1``
  through :func:`~deepinv_tpu_torch.ops.kernels.up_sandwich.up_sandwich`
  (K4), which recomputes the skip ``x2`` from the down chain's output;
- ``"0"``: none.

A stage fuses only with bf16 activations, ReLU blocks and bias-free convs
(``_fusible``), and at the widths its kernel is built for (64 channels at
scale 0 and 128 at scale 1, as the JAX gates ask, resblock_chain.py:292,
:554; projection inputs a multiple of 16 channels);
anywhere else its modules run one by one. Every other conv is plain
``torch.nn.functional``. With ``dim=3`` every conv is 3D and no stage fuses:
the kernels take 4D activations only.

``pretrained`` (a ``.pth``/``.npz`` path or a state dict) loads upstream
weights (drunet.py:138-153): into a 2D model through the upstream names
(:func:`~deepinv_tpu_torch.models.convert.drunet_names`), into a 3D one
inflated from 2D kernels stored under the port's names
(:func:`~deepinv_tpu_torch.models.utils3d.initialize_3d_from_2d`, isotropically
with ``pretrained_2d_isotropic``), as the JAX package does. The JAX package's W-folded forward (drunet_fold.py)
is a TPU lane-layout permutation of the same math and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.kernels.conv_chain import fused_disabled
from ..ops.kernels.resblock_chain import C as CHAIN_C
from ..ops.kernels.resblock_chain import pack_weights, resblock_chain
from ..ops.kernels.up_resblock_chain import pack_up_chain, up_resblock_chain
from ..ops.kernels.up_sandwich import pack_sandwich, up_sandwich
from .base import Denoiser, handle_sigma
from .convert import load_torch_checkpoint, port_drunet
from .layers import Sequential, conv_nd, conv_transpose_nd, fix_dim, memory_format
from .utils import stacked_weights, test_pad
from .utils3d import initialize_3d_from_2d

__all__ = ["DRUNet", "ResBlock"]

_ACTS = {
    "R": F.relu,
    "L": lambda x: F.leaky_relu(x, 1e-2),
    "E": F.elu,
    "S": F.softplus,
    "s": F.softplus,
}

FUSED_MODES = ("0", "down", "up", "both", "1", "sandwich")


def _convs(blocks):
    """The per-layer conv1 and conv2 weights of a chain of ResBlocks."""
    return [b.conv1.weight for b in blocks], [b.conv2.weight for b in blocks]


class ResBlock(torch.nn.Module):
    """``x + conv2(act(conv1(x)))`` (deepinv_tpu/models/drunet.py:56), with
    the reference's 0.2 init gain (drunet.py:69-72); 3D convs with ``dim=3``."""

    def __init__(self, nc: int, bias: bool = False, act_mode: str = "R", dim=2,
                 generator=None):
        super().__init__()
        Conv = conv_nd(dim)
        self.conv1 = Conv(nc, nc, 3, 1, 1, bias=bias, generator=generator)
        self.conv2 = Conv(nc, nc, 3, 1, 1, bias=bias, generator=generator)
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
    :param pretrained: upstream weights: a ``.pth`` or ``.npz`` path, or a
        state dict.
    :param pretrained_2d_isotropic: inflate 2D weights into a 3D model
        isotropically instead of axially.
    :param dim: 2 or 3 spatial dimensions.
    :param generator: CPU ``torch.Generator`` for the random initialization.
    :param device: where the weights are moved after they are drawn on the
        CPU; the CUDA device by default.
    :param fused: which stages run through the kernel ops: ``"down"``,
        ``"up"``, ``"both"`` (= ``"1"``), ``"sandwich"`` or ``"0"`` (module
        docstring). An attribute, so it may be changed after construction.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, nc=(64, 128, 256, 512),
                 nb: int = 4, act_mode: str = "R", pretrained=None,
                 pretrained_2d_isotropic: bool = False, dim=2, generator=None, device=None,
                 fused: str = "down"):
        device = resolve_device(device)
        super().__init__()
        nc = tuple(nc)
        self.nb = nb
        self.fused = fused
        self.dim = dim = fix_dim(dim)
        g = generator
        Conv, ConvT = conv_nd(dim), conv_transpose_nd(dim)
        self.m_head = Conv(in_channels + 1, nc[0], 3, 1, 1, bias=False, generator=g)

        def block(c):
            return ResBlock(c, act_mode=act_mode, dim=dim, generator=g)

        def down_stage(cin, cout):
            return Sequential(*[block(cin) for _ in range(nb)],
                              Conv(cin, cout, 2, 2, 0, bias=False, generator=g))

        def up_stage(cin, cout):
            up = ConvT(cin, cout, 2, 2, 0, bias=False, generator=g)
            return Sequential(up, *[block(cout) for _ in range(nb)])

        self.m_down1 = down_stage(nc[0], nc[1])
        self.m_down2 = down_stage(nc[1], nc[2])
        self.m_down3 = down_stage(nc[2], nc[3])
        self.m_body = Sequential(*[block(nc[3]) for _ in range(nb)])
        self.m_up3 = up_stage(nc[3], nc[2])
        self.m_up2 = up_stage(nc[2], nc[1])
        self.m_up1 = up_stage(nc[1], nc[0])
        self.m_tail = Conv(nc[0], out_channels, 3, 1, 1, bias=False, generator=g)
        if pretrained is not None:
            ckpt = load_torch_checkpoint(pretrained)
            if dim == 3:
                initialize_3d_from_2d(self, ckpt, isotropic=pretrained_2d_isotropic)
            else:
                port_drunet(self, ckpt)
        # channels_last is cuDNN's native layout for bf16 tensor-core convs on
        # the H100 and the resblock-chain kernel's: on NCHW activations cuDNN
        # transposes around every conv, on NCHW weights with NHWC activations
        # it converts the weight each call (measured on an H100: PERF.md).
        # channels_last_3d in 3D.
        self.to(device=device, memory_format=memory_format(dim))

    @property
    def fused(self) -> str:
        return self._fused

    @fused.setter
    def fused(self, mode: str):
        if mode not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, got {mode!r}")
        self._fused = mode

    def _fusible(self, tag: str, v, blocks) -> bool:
        """Whether stage ``tag`` ("down", "up" or "sandwich") runs through its
        kernel op: the mode selects it (``"sandwich"`` implies the down
        chain), no ``fused_chains_disabled()`` context is active
        (resblock_chain.py:159, 286, 546), the activations are bf16 and 4D and the
        blocks ReLU and bias-free (drunet_fold.py:160-178)."""
        mode = self.fused
        ok_mode = (mode in ("1", "both", tag)
                   or (mode == "sandwich" and tag in ("down", "sandwich")))
        return (ok_mode and not fused_disabled() and v.dtype == torch.bfloat16
                and v.dim() == 4 and len(blocks) > 0
                and all(b.act_mode == "R" and b.conv1.bias is None and b.conv2.bias is None
                        for b in blocks))

    def _chain_weights(self, blocks):
        """Stacked OIHW weights of the scale-0 down chain and their kernel
        packing, packed once per weight version (:func:`stacked_weights`)."""
        return stacked_weights(self, _convs(blocks),
                               lambda w1s, w2s: (pack_weights(w1s), pack_weights(w2s)), "down0")

    def _down_chain0(self, x):
        """Scale-0 down chain ``m_down1[:-1]``: the kernel op where it
        applies, the blocks one by one otherwise."""
        blocks = list(self.m_down1[:-1])
        if self._fusible("down", x, blocks) and x.shape[1] == CHAIN_C:
            w1s, w2s, packed = self._chain_weights(blocks)
            return resblock_chain(x, w1s, w2s, packed=packed)
        for b in blocks:
            x = b(x)
        return x

    def _up_chain0(self, v):
        """Scale-0 up stage ``m_up1`` on ``v = x + x2``: the kernel op
        (projection and chain) where it applies, the modules otherwise."""
        up, blocks = self.m_up1[0], list(self.m_up1[1:])
        if (self._fusible("up", v, blocks) and up.weight.shape[1] == CHAIN_C
                and up.weight.shape[0] % 16 == 0 and up.bias is None):
            w_up, w1s, w2s, packed = stacked_weights(self, (up.weight, *_convs(blocks)),
                                                     pack_up_chain, "up0")
            return up_resblock_chain(v, w_up, w1s, w2s, packed=packed)
        return self.m_up1(v)

    def _sandwich(self, s2, d0):
        """The up tail ``m_up1(m_up2(s2) + x2)`` as the K4 op where it
        applies (x2 recomputed from ``d0``), else None."""
        up2, up1, down = self.m_up2[0], self.m_up1[0], self.m_down1[-1]
        blocks1, blocks0 = list(self.m_up2[1:]), list(self.m_up1[1:])
        # only "sandwich" selects it: "both" and "1" pass _fusible's mode test
        # for any tag, as in drunet_fold.py:264
        if not (self.fused == "sandwich" and self._fusible("sandwich", s2, blocks1 + blocks0)
                and blocks1 and blocks0 and d0.shape[1] == CHAIN_C
                and up2.weight.shape[1] == 2 * CHAIN_C and up2.weight.shape[0] % 16 == 0
                and all(m.bias is None for m in (up2, up1, down))):
            return None
        ws = (up2.weight, *_convs(blocks1), down.weight, up1.weight, *_convs(blocks0))
        *stacks, packed = stacked_weights(self, ws, pack_sandwich, "sandwich")
        return up_sandwich(s2, d0, *stacks, packed=packed)

    def forward_unet(self, x0):
        """UNet on the image + noise-map input (drunet.py:163-171), with the
        stages ``fused`` selects on the kernel ops (drunet_fold.py:229-288)."""
        x1 = self.m_head(x0.contiguous(memory_format=memory_format(x0.dim() - 2)))
        d0 = self._down_chain0(x1)
        x2 = self.m_down1[-1](d0)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        x = self.m_body(x4)
        x = self.m_up3(x + x4)
        s2 = x + x3
        v = self._sandwich(s2, d0)
        if v is None:
            v = self._up_chain0(self.m_up2(s2) + x2)
        return self.m_tail(v + x1)

    def forward(self, x, sigma=0.05, **kwargs):
        xin = torch.cat([x, handle_sigma(sigma, x)], dim=1)
        if all(s % 8 == 0 and s > 31 for s in x.shape[2:]):
            return self.forward_unet(xin)
        return test_pad(self.forward_unet, xin, modulo=16)

"""Restormer denoiser (port of deepinv_tpu/models/restormer.py).

Multi-Dconv head transposed attention (MDTA) and the gated depthwise-conv
feed-forward network (GDFN) in a 4-level encoder-decoder. MDTA is channel
attention: ``C/h x C/h`` maps from L2-normalised queries and keys scaled by
a learned temperature, so it is a ``matmul`` + ``softmax`` and not
``scaled_dot_product_attention``. The GELU is the exact erf form (torch's
``nn.GELU``, restormer.py:93), not ``layers.GELU``.

The names of the module tree are the JAX module's; ``convert.restormer_names``
maps them to upstream's (``encoder_level1.0.attn.qkv_dwconv.weight``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import Denoiser
from .layers import Conv2d, PixelShuffle
from .utils import test_pad

__all__ = ["Restormer"]


class _LayerNormC(nn.Module):
    """Layer norm over the channel axis (restormer.py:26). ``BiasFree``
    divides by the standard deviation without centering ``x``, as upstream."""

    def __init__(self, channels: int, ln_type: str = "BiasFree"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.ln_type = ln_type
        if ln_type != "BiasFree":
            self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        var = x.var(dim=1, keepdim=True, unbiased=False)
        w = self.weight.to(x.dtype)[None, :, None, None]
        if self.ln_type == "BiasFree":
            return x / torch.sqrt(var + 1e-5) * w
        mu = x.mean(dim=1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * w + self.bias.to(x.dtype)[None, :, None, None]


class _MDTA(nn.Module):
    """Multi-Dconv head transposed attention (restormer.py:48)."""

    def __init__(self, channels: int, num_heads: int, bias: bool = False, generator=None):
        super().__init__()
        g = generator
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv2d(channels, channels * 3, 1, 1, 0, bias=bias, generator=g)
        self.qkv_dw = Conv2d(channels * 3, channels * 3, 3, 1, 1, bias=bias, groups=channels * 3,
                             generator=g)
        self.proj = Conv2d(channels, channels, 1, 1, 0, bias=bias, generator=g)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.num_heads
        q, k, v = (t.reshape(B, h, C // h, H * W)
                   for t in self.qkv_dw(self.qkv(x)).chunk(3, dim=1))
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.temperature.to(x.dtype)[None], dim=-1)
        return self.proj((attn @ v).reshape(B, C, H, W))


class _GDFN(nn.Module):
    """Gated depthwise-conv feed-forward network (restormer.py:80)."""

    def __init__(self, channels: int, expansion: float, bias: bool = False, generator=None):
        super().__init__()
        hidden = int(channels * expansion)
        g = generator
        self.inp = Conv2d(channels, hidden * 2, 1, 1, 0, bias=bias, generator=g)
        self.dw = Conv2d(hidden * 2, hidden * 2, 3, 1, 1, bias=bias, groups=hidden * 2,
                         generator=g)
        self.out = Conv2d(hidden, channels, 1, 1, 0, bias=bias, generator=g)

    def forward(self, x):
        a, b = self.dw(self.inp(x)).chunk(2, dim=1)
        return self.out(F.gelu(a) * b)


class _TransformerBlock(nn.Module):
    """``x + MDTA(LN(x))``, then ``x + GDFN(LN(x))`` (restormer.py:96)."""

    def __init__(self, channels, num_heads, expansion, bias=False, ln_type="BiasFree",
                 generator=None):
        super().__init__()
        self.norm1 = _LayerNormC(channels, ln_type)
        self.attn = _MDTA(channels, num_heads, bias, generator)
        self.norm2 = _LayerNormC(channels, ln_type)
        self.ffn = _GDFN(channels, expansion, bias, generator)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class _Down(nn.Module):
    """A conv to ``C/2`` channels, then pixel-unshuffle to ``2C`` at half the
    resolution (restormer.py:110)."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        self.conv = Conv2d(channels, channels // 2, 3, 1, 1, bias=False, generator=generator)

    def forward(self, x):
        return F.pixel_unshuffle(self.conv(x), 2)


class _Up(nn.Module):
    """A conv to ``2C`` channels, then pixel-shuffle to ``C/2`` at twice the
    resolution (restormer.py:122)."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        self.conv = Conv2d(channels, channels * 2, 3, 1, 1, bias=False, generator=generator)
        self.shuffle = PixelShuffle(2)

    def forward(self, x):
        return self.shuffle(self.conv(x))


def _blocks(n, *args, **kwargs):
    return nn.ModuleList([_TransformerBlock(*args, **kwargs) for _ in range(n)])


class Restormer(Denoiser):
    """Restormer (restormer.py:131): a blind denoiser, ``sigma`` unused. The
    defaults are the published checkpoints' (dim 48, blocks (4, 6, 6, 8), 4
    refinement blocks, BiasFree layer norm).

    :param pretrained: an upstream checkpoint (``params`` wrapping handled).
    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks=(4, 6, 6, 8), num_refinement_blocks: int = 4, heads=(1, 2, 4, 8),
                 expansion: float = 2.66, bias: bool = False, LayerNorm_type: str = "BiasFree",
                 dual_pixel_task: bool = False, pretrained=None, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        kw = dict(expansion=expansion, bias=bias, ln_type=LayerNorm_type, generator=g)
        self.patch_embed = Conv2d(in_channels, dim, 3, 1, 1, bias=bias, generator=g)
        dims = [dim, dim * 2, dim * 4, dim * 8]
        self.enc = nn.ModuleList([_blocks(num_blocks[lv], dims[lv], heads[lv], **kw)
                                  for lv in range(4)])
        self.downs = nn.ModuleList([_Down(dims[lv], g) for lv in range(3)])
        self.ups = nn.ModuleList([_Up(dims[lv + 1], g) for lv in reversed(range(3))])
        # channel reducers after the skip concatenations of levels 2 and 1
        self.reduce = nn.ModuleList([
            Conv2d(dims[2] * 2, dims[2], 1, 1, 0, bias=bias, generator=g),
            Conv2d(dims[1] * 2, dims[1], 1, 1, 0, bias=bias, generator=g)])
        self.dec = nn.ModuleList([_blocks(num_blocks[2], dims[2], heads[2], **kw),
                                  _blocks(num_blocks[1], dims[1], heads[1], **kw),
                                  _blocks(num_blocks[0], dims[0] * 2, heads[0], **kw)])
        self.refine = _blocks(num_refinement_blocks, dims[0] * 2, heads[0], **kw)
        self.dual_pixel_task = dual_pixel_task
        if dual_pixel_task:
            self.skip_conv = Conv2d(dims[0], dims[0] * 2, 1, 1, 0, bias=bias, generator=g)
        self.out_conv = Conv2d(dims[0] * 2, out_channels, 3, 1, 1, bias=bias, generator=g)
        if pretrained is not None:
            from .convert import load_torch_checkpoint, port_restormer

            port_restormer(self, load_torch_checkpoint(pretrained))
        self.to(device)

    @staticmethod
    def _seq(blocks, h):
        for b in blocks:
            h = b(h)
        return h

    def _forward(self, x):
        emb = self.patch_embed(x)
        h, skips = emb, []
        for lv in range(3):
            h = self._seq(self.enc[lv], h)
            skips.append(h)
            h = self.downs[lv](h)
        h = self._seq(self.enc[3], h)
        h = self.reduce[0](torch.cat([self.ups[0](h), skips[2]], dim=1))
        h = self._seq(self.dec[0], h)
        h = self.reduce[1](torch.cat([self.ups[1](h), skips[1]], dim=1))
        h = self._seq(self.dec[1], h)
        h = torch.cat([self.ups[2](h), skips[0]], dim=1)
        h = self._seq(self.refine, self._seq(self.dec[2], h))
        if self.dual_pixel_task:
            return self.out_conv(h + self.skip_conv(emb))
        return self.out_conv(h) + x

    def forward(self, x, sigma=None, **kwargs):
        if x.shape[-2] % 8 or x.shape[-1] % 8:
            return test_pad(self._forward, x, modulo=8)
        return self._forward(x)

    def forward_restormer(self, x):
        """The network without padding (restormer.py:231): sides must be
        multiples of 8."""
        if x.shape[-2] % 8 or x.shape[-1] % 8:
            raise ValueError("Image spatial dim is not divisible by 8. Spatial dim : "
                             f"({x.shape[-2]},{x.shape[-1]})")
        return self._forward(x)

    # -- the published checkpoints' configurations (restormer.py:243-319) ----

    @staticmethod
    def _is_standard_network(dim, num_blocks, num_refinement_blocks, heads,
                             ffn_expansion_factor, bias):
        if dim != 48:
            raise ValueError(f"EXPECTED dim == 48, INSTEAD of {dim}")
        if list(num_blocks) != [4, 6, 6, 8]:
            raise ValueError(f"EXPECTED num_blocks == [4, 6, 6, 8], INSTEAD of {list(num_blocks)}")
        if num_refinement_blocks != 4:
            raise ValueError(
                f"EXPECTED num_refinement_blocks == 4, INSTEAD of {num_refinement_blocks}")
        if list(heads) != [1, 2, 4, 8]:
            raise ValueError(f"EXPECTED heads == [1, 2, 4, 8], INSTEAD of {list(heads)}")
        if abs(ffn_expansion_factor - 2.66) > 1e-9:
            raise ValueError(
                f"EXPECTED ffn_expansion_factor == 2.66, INSTEAD of {ffn_expansion_factor}")
        if bias:
            raise ValueError(f"EXPECTED bias == False, INSTEAD of {bias}")

    def _is_standard(self, task, ins, out, ln_type, in_channels, out_channels, net,
                     LayerNorm_type, dual_pixel_task, check_dual=True):
        """Raise the JAX package's message where a parameter is not the
        ``task`` checkpoints': ``in_channels`` one of ``ins``, ``out_channels``
        ``out`` (None: ``in_channels``), ``LayerNorm_type`` ``ln_type``."""
        if in_channels not in ins:
            raise ValueError(f"Standard {task} / EXPECTED in_channels == "
                             f"{' or '.join(map(str, ins))}, INSTEAD of {in_channels}")
        if out_channels != (in_channels if out is None else out):
            raise ValueError(f"Standard {task} / EXPECTED out_channels == "
                             f"{'in_channels' if out is None else out}, INSTEAD of {out_channels}")
        self._is_standard_network(*net)
        if LayerNorm_type != ln_type:
            raise ValueError(f"Standard {task} / EXPECTED LayerNorm_type == '{ln_type}', "
                             f"INSTEAD of {LayerNorm_type}")
        if check_dual and dual_pixel_task:
            raise ValueError(f"Standard {task} / EXPECTED dual_pixel_task == False, "
                             f"INSTEAD of {dual_pixel_task}")

    def is_standard_denoising_network(self, in_channels, out_channels, dim, num_blocks,
                                      num_refinement_blocks, heads, ffn_expansion_factor, bias,
                                      LayerNorm_type, dual_pixel_task):
        """Raise unless the parameters are the published denoising
        checkpoints' (restormer.py:261)."""
        self._is_standard("denoising", (1, 3), None, "BiasFree", in_channels, out_channels,
                          (dim, num_blocks, num_refinement_blocks, heads, ffn_expansion_factor,
                           bias), LayerNorm_type, dual_pixel_task)

    def is_standard_deraining_network(self, in_channels, out_channels, dim, num_blocks,
                                      num_refinement_blocks, heads, ffn_expansion_factor, bias,
                                      LayerNorm_type, dual_pixel_task):
        """Raise unless the parameters are the published deraining
        checkpoint's (restormer.py:282)."""
        self._is_standard("deraining", (3,), 3, "WithBias", in_channels, out_channels,
                          (dim, num_blocks, num_refinement_blocks, heads, ffn_expansion_factor,
                           bias), LayerNorm_type, dual_pixel_task)

    def is_standard_deblurring_network(self, in_channels, out_channels, dim, num_blocks,
                                       num_refinement_blocks, heads, ffn_expansion_factor, bias,
                                       LayerNorm_type, dual_pixel_task):
        """Raise unless the parameters are the published motion / defocus
        deblurring checkpoints' (restormer.py:303); the dual-pixel task is
        allowed."""
        self._is_standard("deblurring", (3, 6), 3, "WithBias", in_channels, out_channels,
                          (dim, num_blocks, num_refinement_blocks, heads, ffn_expansion_factor,
                           bias), LayerNorm_type, dual_pixel_task, check_dual=False)

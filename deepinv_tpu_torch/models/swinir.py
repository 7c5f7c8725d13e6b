"""SwinIR restoration transformer (port of deepinv_tpu/models/swinir.py).

Residual groups (RSTB) of Swin blocks: window self-attention (W-MSA, and
SW-MSA on a cyclic shift of half a window with its mask) with a learned
relative-position bias, an MLP with the exact erf GELU (torch's ``nn.GELU``,
swinir.py:155, not ``layers.GELU``), the shallow and deep feature convs and
the denoising / super-resolution heads. Windows fold into the batch; the
attention is ``matmul`` + bias + mask + ``softmax`` as in the JAX module.
The relative-position index is a buffer and each input size's mask is built
once per device.

The names of the module tree are the JAX module's; ``convert.swinir_names``
maps them to upstream's (``layers.0.residual_group.blocks.0.attn.qkv.weight``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import Denoiser
from .layers import Conv2d, Linear, PixelShuffle
from .utils import pad_hw

__all__ = ["SwinIR"]


class _LayerNorm(nn.Module):
    """Layer norm over the last axis (swinir.py:34)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight.to(x.dtype), self.bias.to(x.dtype), 1e-5)


def _rel_pos_index(ws: int) -> np.ndarray:
    """The relative-position lookup table of a ``ws`` window (swinir.py:45)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _window_partition(x, ws: int):
    """``(B, H, W, C)`` to ``(B * nW, ws², C)`` (swinir.py:54)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _window_reverse(wins, ws: int, H: int, W: int):
    """The inverse of :func:`_window_partition` (swinir.py:60)."""
    B = wins.shape[0] // (H // ws * W // ws)
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def _attn_mask(H: int, W: int, ws: int, shift: int):
    """The SW-MSA mask (swinir.py:106): -100 between positions of different
    regions of the shifted image, ``(nW, ws², ws²)``; None without a shift."""
    if shift == 0:
        return None
    img_mask = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class _WindowAttention(nn.Module):
    """W-MSA with the relative-position bias (swinir.py:66)."""

    def __init__(self, dim: int, ws: int, heads: int, qkv_bias: bool = True, qk_scale=None,
                 generator=None):
        super().__init__()
        self.dim, self.ws, self.heads = dim, ws, heads
        self.scale = qk_scale or (dim // heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, generator=generator)
        self.proj = Linear(dim, dim, generator=generator)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("rel_index", torch.from_numpy(_rel_pos_index(ws)).reshape(-1),
                             persistent=False)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        h = self.heads
        q, k, v = self.qkv(x).reshape(B_, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-1, -2)                      # (B_, h, N, N)
        bias = self.relative_position_bias_table[self.rel_index].reshape(N, N, h)
        attn = attn + bias.permute(2, 0, 1).to(x.dtype)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None].to(x.dtype))
            attn = attn.reshape(B_, h, N, N)
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class _SwinBlock(nn.Module):
    """Swin transformer block (swinir.py:122). Where ``input_resolution`` is
    no larger than the window, the window shrinks to it and the shift goes
    (swinir.py:129-131)."""

    def __init__(self, dim, input_resolution, heads, ws, shift, mlp_ratio, qkv_bias=True,
                 qk_scale=None, generator=None):
        super().__init__()
        if min(input_resolution) <= ws:
            shift, ws = 0, min(input_resolution)
        self.ws, self.shift = ws, shift
        self.norm1 = _LayerNorm(dim)
        self.attn = _WindowAttention(dim, ws, heads, qkv_bias, qk_scale, generator)
        self.norm2 = _LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Linear(dim, hidden, generator=generator)
        self.fc2 = Linear(hidden, dim, generator=generator)
        self._masks = {}

    def _mask(self, H, W, device):
        key = (H, W, device)
        if key not in self._masks:
            m = _attn_mask(H, W, self.ws, self.shift)
            self._masks[key] = None if m is None else torch.from_numpy(m).to(device)
        return self._masks[key]

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        h = self.norm1(x).reshape(B, H, W, C)
        if self.shift > 0:
            h = torch.roll(h, (-self.shift, -self.shift), dims=(1, 2))
        wins = self.attn(_window_partition(h, self.ws), self._mask(H, W, x.device))
        h = _window_reverse(wins, self.ws, H, W)
        if self.shift > 0:
            h = torch.roll(h, (self.shift, self.shift), dims=(1, 2))
        x = x + h.reshape(B, L, C)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class _RSTB(nn.Module):
    """Residual Swin transformer block group (swinir.py:159): the blocks
    (W-MSA and SW-MSA in turns), a 3x3 conv, the group's residual."""

    def __init__(self, dim, input_resolution, depth, heads, ws, mlp_ratio, qkv_bias=True,
                 qk_scale=None, generator=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            _SwinBlock(dim, input_resolution, heads, ws, 0 if i % 2 == 0 else ws // 2,
                       mlp_ratio, qkv_bias, qk_scale, generator) for i in range(depth)])
        self.conv = Conv2d(dim, dim, 3, 1, 1, generator=generator)

    def forward(self, x, H: int, W: int):
        res = x
        for b in self.blocks:
            x = b(x, H, W)
        B, L, C = x.shape
        img = self.conv(x.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return img.permute(0, 2, 3, 1).reshape(B, L, C) + res


class SwinIR(Denoiser):
    """SwinIR (swinir.py:184). The defaults are the published denoising
    checkpoints' (embed_dim 180, 6 groups of 6 blocks, window 8).

    :param img_size: the training resolution: it sets where windows shrink.
    :param upsampler: ``""`` (denoising), ``"pixelshuffle"``,
        ``"pixelshuffledirect"`` or ``"nearest+conv"``.
    :param pretrained: an upstream checkpoint (``params`` / ``params_ema``
        wrapping handled).
    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, img_size=128, patch_size=1, in_chans: int = 3, embed_dim: int = 180,
                 depths=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6), window_size: int = 8,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True, qk_scale=None, upscale: int = 1,
                 img_range: float = 1.0, upsampler: str = "", pretrained=None, generator=None,
                 device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.window_size = window_size
        self.upscale = upscale
        self.upsampler = upsampler
        self.img_range = img_range
        mean = [0.4488, 0.4371, 0.4040] if in_chans == 3 else [0.0]
        self.register_buffer("mean", torch.tensor(mean).reshape(1, -1, 1, 1))
        num_feat = 64
        res = (img_size // patch_size,) * 2 if isinstance(img_size, int) \
            else tuple(s // patch_size for s in img_size)
        self.patches_resolution = res
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads_cfg = tuple(num_heads)
        self.mlp_ratio = mlp_ratio
        self.in_chans = in_chans
        self.conv_first = Conv2d(in_chans, embed_dim, 3, 1, 1, generator=g)
        self.patch_norm = _LayerNorm(embed_dim)
        self.layers = nn.ModuleList([
            _RSTB(embed_dim, res, depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                  qk_scale, g) for i in range(len(depths))])
        self.norm = _LayerNorm(embed_dim)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, 1, 1, generator=g)
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = Conv2d(embed_dim, num_feat, 3, 1, 1, generator=g)
            n_up = int(math.log2(upscale)) if upscale != 3 else 1
            fac = 2 if upscale != 3 else 3
            self.upsample = nn.ModuleList([Conv2d(num_feat, fac * fac * num_feat, 3, 1, 1,
                                                  generator=g) for _ in range(n_up)])
            self.shuffle = PixelShuffle(fac)
            self.conv_last = Conv2d(num_feat, in_chans, 3, 1, 1, generator=g)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.ModuleList([Conv2d(embed_dim, upscale ** 2 * in_chans, 3, 1, 1,
                                                  generator=g)])
            self.shuffle = PixelShuffle(upscale)
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = Conv2d(embed_dim, num_feat, 3, 1, 1, generator=g)
            self.conv_up1 = Conv2d(num_feat, num_feat, 3, 1, 1, generator=g)
            if upscale == 4:
                self.conv_up2 = Conv2d(num_feat, num_feat, 3, 1, 1, generator=g)
            self.conv_hr = Conv2d(num_feat, num_feat, 3, 1, 1, generator=g)
            self.conv_last = Conv2d(num_feat, in_chans, 3, 1, 1, generator=g)
        else:
            self.conv_last = Conv2d(embed_dim, in_chans, 3, 1, 1, generator=g)
        if pretrained is not None:
            from .convert import load_torch_checkpoint, port_swinir

            port_swinir(self, load_torch_checkpoint(pretrained))
        self.to(device)

    def check_img_size(self, x):
        """Reflect-pad the bottom and right to multiples of the window
        (swinir.py:272)."""
        ws = self.window_size
        return pad_hw(x, 0, (-x.shape[-2]) % ws, 0, (-x.shape[-1]) % ws, "reflect")

    def flops(self):
        """The analytic FLOP count of one forward at the construction's
        resolution (swinir.py:282)."""
        H, W = self.patches_resolution
        d, ws = self.embed_dim, self.window_size
        total = H * W * self.in_chans * d * 9 + H * W * 3 * d
        for depth, heads in zip(self.depths, self.num_heads_cfg):
            per_block = H * W * d
            nW, N = H * W / ws / ws, ws * ws
            per_block += nW * (N * d * 3 * d + heads * N * (d // heads) * N * 2 + N * d * d)
            per_block += 2 * H * W * d * d * self.mlp_ratio + H * W * d
            total += depth * per_block + H * W * d * d * 9
        total += H * W * 3 * d + H * W * d * d * 9
        return int(total)

    def no_weight_decay(self):
        """Names left out of weight decay by the authors' recipe (swinir.py:306)."""
        return {"absolute_pos_embed"}

    def no_weight_decay_keywords(self):
        """Name keywords left out of weight decay (swinir.py:311)."""
        return {"relative_position_bias_table"}

    def forward_features(self, x):
        B, C, H, W = x.shape
        h = self.patch_norm(x.permute(0, 2, 3, 1).reshape(B, H * W, C))
        for grp in self.layers:
            h = grp(h, H, W)
        return self.norm(h).reshape(B, H, W, C).permute(0, 3, 1, 2)

    def forward(self, x, sigma=None, **kwargs):
        """Restore ``x``; ``sigma`` is unused (swinir.py:325)."""
        H, W = x.shape[-2:]
        x = self.check_img_size(x)
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        h = self.conv_first(x)
        h = self.conv_after_body(self.forward_features(h)) + h
        if self.upsampler == "pixelshuffle":
            h = F.leaky_relu(self.conv_before_upsample(h), 0.01)
            for up in self.upsample:
                h = self.shuffle(up(h))
            out = self.conv_last(h)
        elif self.upsampler == "pixelshuffledirect":
            out = self.shuffle(self.upsample[0](h))
        elif self.upsampler == "nearest+conv":
            h = F.leaky_relu(self.conv_before_upsample(h), 0.01)
            up2 = h.repeat_interleave(2, -2).repeat_interleave(2, -1)
            h = F.leaky_relu(self.conv_up1(up2), 0.2)
            if self.upscale == 4:
                up2 = h.repeat_interleave(2, -2).repeat_interleave(2, -1)
                h = F.leaky_relu(self.conv_up2(up2), 0.2)
            out = self.conv_last(F.leaky_relu(self.conv_hr(h), 0.2))
        else:
            out = x + self.conv_last(h)
        out = out / self.img_range + mean
        return out[:, :, :H * self.upscale, :W * self.upscale]

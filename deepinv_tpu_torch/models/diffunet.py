"""Diffusion UNet and EDM preconditioning (port of
deepinv_tpu/models/diffunet.py).

A compact ADM-style UNet: sinusoidal timestep embedding, GroupNorm
scale-shift residual blocks, single-head self-attention over H·W at the
levels from ``attn_level`` on. ``EDMPrecond`` wraps any backbone into a
sigma-calibrated denoiser ``D(x, sigma)``.

Attention is ``F.scaled_dot_product_attention`` on ``(B, H·W, C)`` views: the
JAX module's ``einsum`` + ``softmax`` (diffunet.py:80-86), with its scale
``1/sqrt(C)``. The time embedding runs in the activations' dtype.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import Denoiser
from .layers import Conv2d, Linear, UpsampleNearest
from .utils import pad_hw, test_pad

__all__ = ["DiffUNet", "EDMPrecond", "GroupNorm"]


class GroupNorm(nn.Module):
    """Group norm over ``min(groups, C)`` groups with the biased variance
    (diffunet.py:25)."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = min(groups, channels)
        self.eps = eps

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


def timestep_embedding(t, dim: int) -> torch.Tensor:
    """Sinusoidal embedding ``[cos(t f), sin(t f)]``, ``f = 10000^(-k/half)``
    (diffunet.py:43)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device,
                                                        dtype=torch.float32) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(t.dtype)


class _ResBlock(nn.Module):
    """GroupNorm-SiLU-conv twice, the second norm scaled and shifted by the
    embedding (diffunet.py:51); ``conv2`` starts at zero."""

    def __init__(self, cin: int, cout: int, emb_dim: int, generator=None):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv2d(cin, cout, 3, 1, 1, generator=generator)
        self.emb = Linear(emb_dim, 2 * cout, generator=generator)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, generator=generator)
        with torch.no_grad():
            self.conv2.weight.zero_()
        self.skip = Conv2d(cin, cout, 1, 1, 0, generator=generator) if cin != cout else None

    def forward(self, x, emb):
        h = self.conv1(F.silu(self.norm1(x)))
        scale, shift = self.emb(F.silu(emb))[:, :, None, None].chunk(2, dim=1)
        h = self.norm2(h) * (1 + scale) + shift
        h = self.conv2(F.silu(h))
        return (self.skip(x) if self.skip is not None else x) + h


class _Attention(nn.Module):
    """Single-head self-attention over the ``H·W`` positions (diffunet.py:72);
    ``proj`` starts at zero."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.qkv = Conv2d(channels, 3 * channels, 1, 1, 0, generator=generator)
        self.proj = Conv2d(channels, channels, 1, 1, 0, generator=generator)
        with torch.no_grad():
            self.proj.weight.zero_()

    def forward(self, x):
        B, C, H, W = x.shape
        q, k, v = self.qkv(self.norm(x)).reshape(B, 3, C, H * W).transpose(-1, -2).unbind(1)
        out = F.scaled_dot_product_attention(q, k, v)          # (B, HW, C)
        return x + self.proj(out.transpose(-1, -2).reshape(B, C, H, W))


def _cast_floats(module: nn.Module, src: torch.dtype, dst: torch.dtype) -> nn.Module:
    """A copy of ``module`` with its ``src`` parameters and buffers in ``dst``."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for m in out.modules():
            for d in (m._parameters, m._buffers):
                for n, t in d.items():
                    if t is not None and t.dtype == src:
                        d[n] = nn.Parameter(t.to(dst), t.requires_grad) \
                            if isinstance(t, nn.Parameter) else t.to(dst)
    return out


class DiffUNet(Denoiser):
    """ADM-style diffusion UNet (diffunet.py:89).

    ``forward(x, sigma)`` is a denoiser: ``log(sigma)`` is embedded and the
    predicted noise converted to ``x - sigma * eps``. ``type_t="timestep"``
    returns the noise predicted at raw diffusion timesteps, and
    ``type_t="noise_level"`` denoises through the DDPM schedule
    (:meth:`forward_denoise`).

    :param nc: widths of the levels.
    :param attn_level: the first level with attention after each block.
    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, nc=(32, 64, 128),
                 num_res_blocks: int = 2, attn_level: int = 2, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        nc = tuple(nc)
        emb_dim = nc[0] * 4
        self.emb1 = Linear(nc[0], emb_dim, generator=g)
        self.emb2 = Linear(emb_dim, emb_dim, generator=g)
        self.emb_dim_in = nc[0]
        self.head = Conv2d(in_channels, nc[0], 3, 1, 1, generator=g)
        self.down_blocks = nn.ModuleList()
        ch = nc[0]
        for lvl, c in enumerate(nc):
            blocks = nn.ModuleList()
            for _ in range(num_res_blocks):
                blocks.append(_ResBlock(ch, c, emb_dim, g))
                ch = c
                if lvl >= attn_level:
                    blocks.append(_Attention(c, g))
            self.down_blocks.append(blocks)
        self.downs = nn.ModuleList([Conv2d(nc[i], nc[i], 3, 2, 1, generator=g)
                                    for i in range(len(nc) - 1)])
        self.mid1 = _ResBlock(nc[-1], nc[-1], emb_dim, g)
        self.mid_attn = _Attention(nc[-1], g)
        self.mid2 = _ResBlock(nc[-1], nc[-1], emb_dim, g)
        self.up_blocks = nn.ModuleList()
        self.ups = nn.ModuleList()
        for lvl in reversed(range(len(nc))):
            c = nc[lvl]
            blocks = nn.ModuleList()
            for i in range(num_res_blocks):
                # the skip is concatenated before the first block only: the
                # JAX module's later blocks take ch + c channels and are fed
                # c (diffunet.py:136-137, 164-171): num_res_blocks > 1 raises there
                blocks.append(_ResBlock(ch + c if i == 0 else c, c, emb_dim, g))
                ch = c
                if lvl >= attn_level:
                    blocks.append(_Attention(c, g))
            self.up_blocks.append(blocks)
            if lvl > 0:
                self.ups.append(Conv2d(c, nc[lvl - 1], 3, 1, 1, generator=g))
                ch = nc[lvl - 1]
        self.out_norm = GroupNorm(nc[0])
        self.out_conv = Conv2d(nc[0], out_channels, 3, 1, 1, generator=g)
        self.upsample = UpsampleNearest(2)
        self.to(device)

    @staticmethod
    def _run(blocks, h, emb):
        for b in blocks:
            h = b(h, emb) if isinstance(b, _ResBlock) else b(h)
        return h

    def _forward(self, x, t_emb):
        emb = self.emb2(F.silu(self.emb1(t_emb.to(x.dtype))))
        h = self.head(x)
        skips = []
        for lvl, blocks in enumerate(self.down_blocks):
            h = self._run(blocks, h, emb)
            skips.append(h)
            if lvl < len(self.downs):
                h = self.downs[lvl](h)
        h = self.mid2(self.mid_attn(self.mid1(h, emb)), emb)
        for i, blocks in enumerate(self.up_blocks):
            skip = skips[len(skips) - 1 - i]
            if h.shape[-2:] != skip.shape[-2:]:
                h = self.upsample(h)[..., :skip.shape[-2], :skip.shape[-1]]
            h = self._run(blocks, torch.cat([h, skip], dim=1), emb)
            if i < len(self.ups):
                h = self.ups[i](h)
        return self.out_conv(F.silu(self.out_norm(h)))

    @staticmethod
    def _per_sample(v, x, dtype) -> torch.Tensor:
        s = torch.as_tensor(v, dtype=dtype, device=x.device).reshape(-1)
        return s.expand(x.shape[0]) if s.shape[0] != x.shape[0] else s

    def forward(self, x, sigma=0.05, y=None, type_t: str = None, **kwargs):
        if type_t == "timestep":
            return self.forward_diffusion(x, sigma, y=y)
        if type_t == "noise_level":
            return self.forward_denoise(x, sigma, y=y)
        s = self._per_sample(sigma, x, x.dtype)
        t_emb = timestep_embedding(torch.log(s.clamp_min(1e-5)), self.emb_dim_in)
        mod = 2 ** len(self.downs)
        if x.shape[-2] % mod or x.shape[-1] % mod:
            eps = test_pad(lambda u: self._forward(u, t_emb), x, modulo=mod)
        else:
            eps = self._forward(x, t_emb)
        return x - s.reshape(-1, 1, 1, 1) * eps

    # -- the reference's protocol (diffunet.py:199-293) ----------------------

    def forward_diffusion(self, x, timesteps, y=None):
        """The noise predicted at diffusion ``timesteps`` (diffunet.py:199)."""
        t = self._per_sample(timesteps, x, torch.float32)
        return self._forward(x, timestep_embedding(t, self.emb_dim_in))

    def get_alpha_prod(self, beta_start: float = 0.1 / 1000, beta_end: float = 20 / 1000,
                       num_train_timesteps: int = 1000):
        """The DDPM tables ``(sqrt(1 - ac) / sqrt(ac), sqrt(1 / ac),
        sqrt(1 / ac - 1), sqrt(1 - ac), sqrt(ac))`` of the cumulative alphas,
        float32 on the model's device (diffunet.py:208)."""
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
        ac = np.cumprod(np.float32(1.0) - betas, dtype=np.float32)
        sqrt_ac, sqrt_1m_ac = np.sqrt(ac), np.sqrt(np.float32(1.0) - ac)
        dev = self.head.weight.device
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (
            sqrt_1m_ac / sqrt_ac, np.sqrt(np.float32(1.0) / ac),
            np.sqrt(np.float32(1.0) / ac - np.float32(1.0)), sqrt_1m_ac, sqrt_ac))

    @staticmethod
    def find_nearest(array, value) -> torch.Tensor:
        """The index of the nearest entry of ``array`` for each value
        (diffunet.py:228)."""
        value = torch.as_tensor(value, device=array.device).reshape(-1)
        return torch.argmin((array[:, None] - value[None, :]).abs(), dim=0)

    def forward_denoise(self, x, sigma, y=None):
        """Denoise ``x`` in [0, 1] at ``sigma`` through the DDPM schedule
        (diffunet.py:235): rescale to ``sqrt(alpha) (2x - 1)``, take the
        nearest trained timestep, predict the noise and return the clean
        estimate in [0, 1]. The rescaling runs in float32, the network in
        ``x``'s dtype."""
        s = self._per_sample(sigma, x, torch.float32)
        alpha = 1.0 / (1.0 + 4.0 * s ** 2)
        xs = alpha.sqrt()[:, None, None, None] * (2.0 * x.float() - 1.0)
        _, sqrt_recip_ac, sqrt_recipm1_ac, sqrt_1m_ac, _ = self.get_alpha_prod()
        t = self.find_nearest(sqrt_1m_ac, s * alpha.sqrt() * 2.0)
        eps = self.forward_diffusion(xs.to(x.dtype), t.float(), y=y).float()
        if eps.shape[1] == 2 * x.shape[1]:       # learned-variance heads
            eps = eps[:, :x.shape[1]]
        x0 = sqrt_recip_ac[t][:, None, None, None] * xs \
            - sqrt_recipm1_ac[t][:, None, None, None] * eps
        return ((x0 + 1.0) / 2.0).to(x.dtype)

    def patch_forward(self, x, t, y=None, type_t: str = "noise_level", patch_size: int = 512):
        """The model over non-overlapping ``patch_size`` tiles (diffunet.py:255):
        wrap-pad the top and left to a multiple of the tile, run the tiles one
        after another, reassemble and crop."""
        B, C, H, W = x.shape
        ph, pw = (-H) % patch_size, (-W) % patch_size
        xp = pad_hw(x, ph, 0, pw, 0, "wrap")
        Hp, Wp = xp.shape[-2:]
        nh, nw = Hp // patch_size, Wp // patch_size
        tiles = xp.reshape(B, C, nh, patch_size, nw, patch_size).permute(2, 4, 0, 1, 3, 5)
        tiles = tiles.reshape(nh * nw, B, C, patch_size, patch_size)
        out = torch.stack([self(p, t, y=y, type_t=type_t) for p in tiles])
        out = out.reshape(nh, nw, B, -1, patch_size, patch_size).permute(2, 3, 0, 4, 1, 5)
        return out.reshape(B, -1, Hp, Wp)[..., ph:, pw:]

    def convert_to_fp16(self):
        """A copy with the float32 parameters in bfloat16 (diffunet.py:275),
        as the JAX package's: the card's half-width format of choice too."""
        return _cast_floats(self, torch.float32, torch.bfloat16)

    def convert_to_fp32(self):
        """A copy with the bfloat16 parameters in float32 (diffunet.py:284)."""
        return _cast_floats(self, torch.bfloat16, torch.float32)


class EDMPrecond(Denoiser):
    r"""Karras et al.'s preconditioning (diffunet.py:296):
    ``D(x, sigma) = c_skip x + c_out F(c_in x, c_noise)`` with ``c_noise =
    log(sigma) / 4`` passed as the backbone's noise level, as the JAX
    package does (a ``DiffUNet`` backbone takes its log once more)."""

    def __init__(self, model: nn.Module, sigma_data: float = 0.5):
        super().__init__()
        self.model = model
        self.sigma_data = sigma_data

    def forward(self, x, sigma=0.05, **kwargs):
        s = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1, 1, 1, 1)
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (s ** 2 + sd2)
        c_out = s * self.sigma_data / torch.sqrt(s ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sd2 + s ** 2)
        c_noise = torch.log(s[:, 0, 0, 0].clamp_min(1e-8)) / 4
        return c_skip * x + c_out * self.model(c_in * x, c_noise)

"""NCSN++ / DDPM++ score UNet with EDM preconditioning (port of
deepinv_tpu/models/ncsnpp.py; upstream NVlabs/edm ``SongUNet``).

The encoder and decoder are ``nn.ModuleDict``s keyed by the JAX module's
``enc_names`` / ``dec_names`` (``"64x64_conv"``, ``"32x32_block0"``, ...),
upstream's ``enc`` / ``dec`` keys, so the published EDM checkpoints and the
JAX tree map name for name (:meth:`NCSNpp.jax_names`,
``convert.ncsnpp_names``). The FIR resampling of :class:`UpDownConv2d` is a
grouped ``conv2d`` / ``conv_transpose2d`` with the filter, as upstream's;
attention is ``F.scaled_dot_product_attention`` (ncsnpp.py:186-192 computes
it as ``einsum`` + ``softmax``, the same ``1/sqrt(d)`` scale). The
embedding runs in the activations' dtype. Dropout is absent (inference).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import Denoiser, handle_sigma

__all__ = ["NCSNpp", "UNetBlock", "UpDownConv2d"]


def _xavier_uniform(shape, fan_in, fan_out, gain=1.0, generator=None):
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return gain * (torch.rand(shape, generator=generator) * 2 * lim - lim)


class _GroupNorm(nn.Module):
    """Group norm over ``min(32, C)`` groups (ncsnpp.py:40)."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.num_groups = min(num_groups, num_channels)
        self.eps = eps

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


def _depthwise_down(x, f, pad):
    """Each channel filtered by ``f`` with stride 2 (ncsnpp.py:64)."""
    C = x.shape[1]
    return F.conv2d(x, f.expand(C, 1, -1, -1), stride=2, padding=pad, groups=C)


def _depthwise_up(x, f4, pad):
    """``conv_transpose2d`` of each channel by ``f4`` with stride 2
    (ncsnpp.py:72: the JAX package's dilated conv of the flipped filter)."""
    C = x.shape[1]
    return F.conv_transpose2d(x, f4.expand(C, 1, -1, -1), stride=2, padding=pad, groups=C)


class UpDownConv2d(nn.Module):
    """A conv with an optional (fused) 2x up- or downsampling by a FIR
    filter (ncsnpp.py:83, upstream's EDM ``Conv2d``)."""

    def __init__(self, in_channels, out_channels, kernel, bias=True, up=False, down=False,
                 resample_filter=(1, 1), fused_resample=False, init_weight=1.0, generator=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.up = up
        self.down = down
        self.fused_resample = fused_resample
        fan_in, fan_out = in_channels * kernel * kernel, out_channels * kernel * kernel
        self.weight = nn.Parameter(_xavier_uniform(
            (out_channels, in_channels, kernel, kernel), fan_in, fan_out, init_weight,
            generator)) if kernel else None
        self.bias = nn.Parameter(torch.zeros(out_channels)) if kernel and bias else None
        f = np.asarray(resample_filter, np.float32)
        f = np.outer(f, f)[None, None] / f.sum() ** 2
        self.register_buffer("resample_filter", torch.from_numpy(f.astype(np.float32))
                             if up or down else None)

    def forward(self, x):
        w = self.weight.to(x.dtype) if self.weight is not None else None
        f = self.resample_filter.to(x.dtype) if self.resample_filter is not None else None
        w_pad = w.shape[-1] // 2 if w is not None else 0
        f_pad = (f.shape[-1] - 1) // 2 if f is not None else 0
        if self.fused_resample and self.up and w is not None:
            x = _depthwise_up(x, f * 4, max(f_pad - w_pad, 0))
            x = F.conv2d(x, w, padding=max(w_pad - f_pad, 0))
        elif self.fused_resample and self.down and w is not None:
            x = F.conv2d(x, w, padding=w_pad + f_pad)
            x = _depthwise_down(x, f, 0)
        else:
            if self.up:
                x = _depthwise_up(x, f * 4, f_pad)
            if self.down:
                x = _depthwise_down(x, f, f_pad)
            if w is not None:
                x = F.conv2d(x, w, padding=w_pad)
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)[None, :, None, None]
        return x


class UNetBlock(nn.Module):
    """DDPM++ / NCSN++ residual block with optional attention (ncsnpp.py:133)."""

    def __init__(self, in_channels, out_channels, emb_channels, up=False, down=False,
                 attention=False, num_heads=None, channels_per_head=64, skip_scale=1.0,
                 eps=1e-5, resample_filter=(1, 1), resample_proj=False, adaptive_scale=True,
                 attn_gain=1.0, generator=None):
        super().__init__()
        g = generator
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_heads = 0 if not attention else (
            num_heads if num_heads is not None else out_channels // channels_per_head)
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale
        self.norm0 = _GroupNorm(in_channels, eps=eps)
        self.conv0 = UpDownConv2d(in_channels, out_channels, 3, up=up, down=down,
                                  resample_filter=resample_filter, generator=g)
        aff_out = out_channels * (2 if adaptive_scale else 1)
        self.affine_w = nn.Parameter(_xavier_uniform((aff_out, emb_channels), emb_channels,
                                                     aff_out, generator=g))
        self.affine_b = nn.Parameter(torch.zeros(aff_out))
        self.norm1 = _GroupNorm(out_channels, eps=eps)
        self.conv1 = UpDownConv2d(out_channels, out_channels, 3, init_weight=1e-5, generator=g)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if resample_proj or out_channels != in_channels else 0
            self.skip = UpDownConv2d(in_channels, out_channels, kernel, up=up, down=down,
                                     resample_filter=resample_filter, generator=g)
        if self.num_heads:
            self.norm2 = _GroupNorm(out_channels, eps=eps)
            self.qkv = UpDownConv2d(out_channels, out_channels * 3, 1, init_weight=attn_gain,
                                    generator=g)
            self.proj = UpDownConv2d(out_channels, out_channels, 1, init_weight=1e-5,
                                     generator=g)

    def forward(self, x, emb):
        orig = x
        x = self.conv0(F.silu(self.norm0(x)))
        params = F.linear(emb, self.affine_w.to(x.dtype), self.affine_b.to(x.dtype))
        params = params[..., None, None]
        if self.adaptive_scale:
            scale, shift = params.chunk(2, dim=1)
            x = F.silu(shift + self.norm1(x) * (scale + 1))
        else:
            x = F.silu(self.norm1(x + params))
        x = self.conv1(x)
        x = x + (self.skip(orig) if self.skip is not None else orig)
        x = x * self.skip_scale
        if self.num_heads:
            B, C, H, W = x.shape
            n, d = B * self.num_heads, C // self.num_heads
            q, k, v = self.qkv(self.norm2(x)).reshape(n, d, 3, H * W).permute(2, 0, 3, 1)
            a = F.scaled_dot_product_attention(q, k, v)             # (n, HW, d)
            x = self.proj(a.transpose(1, 2).reshape(B, C, H, W)) + x
            x = x * self.skip_scale
        return x


class _PositionalEmbedding(nn.Module):
    """``[cos(x f), sin(x f)]``, ``f = (1/max_positions)^(k/(n - endpoint))``
    (ncsnpp.py:203)."""

    def __init__(self, num_channels, max_positions=10000, endpoint=False):
        super().__init__()
        self.num_channels = num_channels
        self.max_positions = max_positions
        self.endpoint = endpoint

    def forward(self, x):
        n = self.num_channels // 2
        freqs = torch.arange(n, dtype=torch.float32, device=x.device)
        freqs = freqs / (n - (1 if self.endpoint else 0))
        freqs = (1 / self.max_positions) ** freqs
        x = torch.outer(x.float(), freqs).to(x.dtype)
        return torch.cat([torch.cos(x), torch.sin(x)], dim=1)


class _FourierEmbedding(nn.Module):
    """Random Fourier features ``[cos(2 pi x f), sin(2 pi x f)]``
    (ncsnpp.py:218); ``freqs`` is a buffer, as upstream's."""

    def __init__(self, num_channels, scale=16, generator=None):
        super().__init__()
        self.register_buffer("freqs", torch.randn(num_channels // 2, generator=generator) * scale)

    def forward(self, x):
        x = torch.outer(x, (2 * np.pi * self.freqs).to(x.dtype))
        return torch.cat([torch.cos(x), torch.sin(x)], dim=1)


class NCSNpp(Denoiser):
    """NCSN++ (``"ncsn"``) / DDPM++ (``"ddpm"``) UNet with EDM (``"edm"``) or
    VE-baseline (``"ve-baseline"``) preconditioning (ncsnpp.py:228). The
    defaults are EDM's 64² configuration.

    :param pretrained: an upstream EDM checkpoint; loading sets
        ``pixel_std=0.5`` and the [-1, 1] convention, as the JAX package does.
    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, model_type="ncsn", precondition_type="edm", img_resolution=64,
                 in_channels=3, out_channels=3, label_dim=0, augment_dim=9, model_channels=128,
                 channel_mult=(1, 2, 2, 2), channel_mult_emb=4, num_blocks=4,
                 attn_resolutions=(16,), pretrained=None, _was_trained_on_minus_one_one=False,
                 pixel_std=0.75, generator=None, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__()
        g = generator
        model_type = model_type.lower()
        if model_type == "ncsn":
            embedding_type, channel_mult_noise = "fourier", 2
            encoder_type, resample_filter = "residual", (1, 3, 3, 1)
        elif model_type == "ddpm":
            embedding_type, channel_mult_noise = "positional", 1
            encoder_type, resample_filter = "standard", (1, 1)
        else:
            raise ValueError(f"model_type must be 'ncsn' or 'ddpm', got {model_type}")
        self.precondition_type = precondition_type.lower()
        self.pixel_std = pixel_std
        self._was_trained_on_minus_one_one = _was_trained_on_minus_one_one
        emb_channels = model_channels * channel_mult_emb
        noise_channels = model_channels * channel_mult_noise
        block_kwargs = dict(emb_channels=emb_channels, num_heads=1, skip_scale=math.sqrt(0.5),
                            eps=1e-6, resample_filter=resample_filter, resample_proj=True,
                            adaptive_scale=False, attn_gain=math.sqrt(0.2), generator=g)
        self.map_noise = (_PositionalEmbedding(noise_channels, endpoint=True)
                          if embedding_type == "positional"
                          else _FourierEmbedding(noise_channels, generator=g))
        self.label_dim = label_dim
        if label_dim:
            self.map_label_w = nn.Parameter(_xavier_uniform(
                (noise_channels, label_dim), label_dim, noise_channels, generator=g))
            self.map_label_b = nn.Parameter(torch.zeros(noise_channels))
        self.map_augment_w = nn.Parameter(_xavier_uniform(
            (noise_channels, augment_dim), augment_dim, noise_channels, generator=g)) \
            if augment_dim else None
        self.map_layer0_w = nn.Parameter(_xavier_uniform(
            (emb_channels, noise_channels), noise_channels, emb_channels, generator=g))
        self.map_layer0_b = nn.Parameter(torch.zeros(emb_channels))
        self.map_layer1_w = nn.Parameter(_xavier_uniform(
            (emb_channels, emb_channels), emb_channels, emb_channels, generator=g))
        self.map_layer1_b = nn.Parameter(torch.zeros(emb_channels))

        self.enc = nn.ModuleDict()
        cout = caux = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels
                self.enc[f"{res}x{res}_conv"] = UpDownConv2d(cin, cout, 3, generator=g)
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **block_kwargs)
                if encoder_type == "residual":
                    self.enc[f"{res}x{res}_aux_residual"] = UpDownConv2d(
                        caux, cout, 3, down=True, resample_filter=resample_filter,
                        fused_resample=True, generator=g)
                    caux = cout
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block_kwargs)
        skips = [b.out_channels for n, b in self.enc.items() if "aux" not in n]
        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True,
                                                         **block_kwargs)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **block_kwargs)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **block_kwargs)
            for idx in range(num_blocks + 1):
                cin = cout + skips.pop()
                cout = model_channels * mult
                attn = idx == num_blocks and res in attn_resolutions
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(cin, cout, attention=attn,
                                                                **block_kwargs)
            if level == 0:
                self.dec[f"{res}x{res}_aux_norm"] = _GroupNorm(cout, eps=1e-6)
                self.dec[f"{res}x{res}_aux_conv"] = UpDownConv2d(cout, out_channels, 3,
                                                                 init_weight=1e-5, generator=g)
        if pretrained is not None:
            from .convert import load_torch_checkpoint, port_ncsnpp

            port_ncsnpp(self, load_torch_checkpoint(pretrained))
            # the published EDM checkpoints are [-1, 1] models with pixel_std 0.5
            self.pixel_std = 0.5
            self._was_trained_on_minus_one_one = True
        self.to(device)

    @property
    def enc_names(self) -> list:
        return list(self.enc)

    @property
    def dec_names(self) -> list:
        return list(self.dec)

    def jax_names(self) -> dict:
        """The JAX module's tree path of each tensor: ``enc.{name}`` is
        ``enc_blocks.{i}`` with ``name`` the i-th of ``enc_names``."""
        index = {f"enc.{n}": f"enc_blocks.{i}" for i, n in enumerate(self.enc)}
        index.update({f"dec.{n}": f"dec_blocks.{i}" for i, n in enumerate(self.dec)})
        names = {}
        for k in self.state_dict():
            top, _, rest = k.partition(".")
            if top in ("enc", "dec"):
                name, _, leaf = rest.partition(".")
                names[k] = f"{index[f'{top}.{name}']}.{leaf}"
            else:
                names[k] = k
        return names

    def forward_unet(self, x, sigma, class_labels=None, augment_labels=None):
        """The UNet on ``x`` at the noise conditioning ``sigma`` ``(B,)``
        (ncsnpp.py:357)."""
        emb = self.map_noise(sigma.to(x.dtype))
        B = emb.shape[0]
        emb = emb.reshape(B, 2, -1).flip(1).reshape(B, -1)          # swap sin and cos
        if self.label_dim and class_labels is not None:
            emb = emb + F.linear(class_labels.to(x.dtype) * math.sqrt(self.label_dim),
                                 self.map_label_w.to(x.dtype), self.map_label_b.to(x.dtype))
        if self.map_augment_w is not None and augment_labels is not None:
            emb = emb + F.linear(augment_labels.to(x.dtype), self.map_augment_w.to(x.dtype))
        emb = F.silu(F.linear(emb, self.map_layer0_w.to(x.dtype), self.map_layer0_b.to(x.dtype)))
        emb = F.silu(F.linear(emb, self.map_layer1_w.to(x.dtype), self.map_layer1_b.to(x.dtype)))
        skips = []
        aux = x
        for name, block in self.enc.items():
            if "aux_residual" in name:
                x = aux = (x + block(aux)) / math.sqrt(2)
                skips[-1] = x
            else:
                x = block(x, emb) if isinstance(block, UNetBlock) else block(x)
                skips.append(x)
        aux = tmp = None
        for name, block in self.dec.items():
            if "aux_norm" in name:
                tmp = block(x)
            elif "aux_conv" in name:
                tmp = block(F.silu(tmp))
                aux = tmp if aux is None else tmp + aux
            else:
                if x.shape[1] != block.in_channels:
                    x = torch.cat([x, skips.pop()], dim=1)
                x = block(x, emb)
        return aux

    def forward(self, x, sigma, class_labels=None, augment_labels=None,
                input_in_minus_one_one=False, **kwargs):
        sigma = handle_sigma(sigma, x)[:, :, :1, :1]
        rescale = self._was_trained_on_minus_one_one and not input_in_minus_one_one
        if rescale:
            x = (x - 0.5) * 2.0
            sigma = sigma * 2.0
        if self.precondition_type == "edm":
            s2, p2 = sigma ** 2, self.pixel_std ** 2
            c_skip = p2 / (s2 + p2)
            c_out = sigma * self.pixel_std / torch.sqrt(s2 + p2)
            c_in = 1 / torch.sqrt(p2 + s2)
            c_noise = torch.log(sigma) / 4
        elif self.precondition_type in ("ve-baseline", "baseline_ve"):
            c_skip, c_out, c_in = 1.0, sigma, 1.0
            c_noise = torch.log(sigma / 2)
        else:
            raise NotImplementedError(self.precondition_type)
        F_x = self.forward_unet(c_in * x, c_noise.reshape(-1), class_labels=class_labels,
                                augment_labels=augment_labels)
        D_x = c_skip * x + c_out * F_x
        return (D_x + 1.0) / 2.0 if rescale else D_x

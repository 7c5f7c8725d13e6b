"""The guided-diffusion (ADM) UNet of Dhariwal & Nichol (port of
deepinv_tpu/models/adm.py).

The module tree is guided-diffusion's, so ``state_dict()`` names every
tensor as the published checkpoints (``diffusion_ffhq_10m.pt``,
``diffusion_openai.pt``) and the JAX module's flat dict do:
``input_blocks.{i}.{j}.in_layers.0.weight``, ``middle_block.1.qkv.weight``,
``out.2.bias``. Loading a checkpoint is a strict copy by those names.

Architecture (adm.py:12-16): a conv stem; per level residual blocks with
scale-shift GroupNorm(32) conditioning on the timestep, BigGAN-style up and
down residual blocks (average pool / nearest upsampling inside), multi-head
attention of 64 channels a head at the configured resolutions, and a
learned-variance head of twice the image channels. Inference only: dropout
is absent.

Attention is ``F.scaled_dot_product_attention`` (adm.py:284-299 computes it
as ``einsum`` + ``softmax`` with the same ``1/sqrt(64)`` scale). The time
embedding runs in the activations' dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import Denoiser
from .utils import pad_hw

__all__ = ["ADMUNet"]


class _Affine(nn.Module):
    """A weight and a bias, the tensors of one guided-diffusion layer."""

    def __init__(self, wshape, bshape):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(wshape))
        self.bias = nn.Parameter(torch.zeros(bshape))


class _Seq(nn.Module):
    """Numbered slots, only some of which hold tensors (``in_layers.0``,
    ``in_layers.2``): the positions of guided-diffusion's ``nn.Sequential``."""

    def __init__(self, slots: dict):
        super().__init__()
        for i, m in slots.items():
            self.add_module(str(i), m)

    def __getitem__(self, i):
        return self._modules[str(i)]


def _norm(ch):
    return _Affine((ch,), (ch,))


def _conv(cout, cin, k):
    return _Affine((cout, cin, k, k), (cout,))


class _Res(nn.Module):
    """Residual block (adm.py:180-193 shapes, :262 forward)."""

    def __init__(self, cin, cout, emb):
        super().__init__()
        self.in_layers = _Seq({0: _norm(cin), 2: _conv(cout, cin, 3)})
        self.emb_layers = _Seq({1: _Affine((2 * cout, emb), (2 * cout,))})
        self.out_layers = _Seq({0: _norm(cout), 3: _conv(cout, cout, 3)})
        if cin != cout:
            self.skip_connection = _conv(cout, cin, 1)


class _Attn(nn.Module):
    """Attention block (adm.py:195-201 shapes, :284 forward)."""

    def __init__(self, ch):
        super().__init__()
        self.norm = _norm(ch)
        self.qkv = _Affine((3 * ch, ch, 1), (3 * ch,))
        self.proj_out = _Affine((ch, ch, 1), (ch,))


def _group_norm(x, p):
    return F.group_norm(x, 32, p.weight.to(x.dtype), p.bias.to(x.dtype), 1e-5)


def _conv2d(x, p, padding: int = 1):
    return F.conv2d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), 1, padding)


def _linear(x, p):
    return F.linear(x, p.weight.to(x.dtype), p.bias.to(x.dtype))


def _timestep_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ADMUNet(Denoiser):
    r"""Guided-diffusion UNet (adm.py:85). ``large_model=False``: 128 base
    channels, one residual block a level, attention at 16x16 (the FFHQ
    checkpoint); ``True``: 256 channels, two blocks, attention at 8, 16 and
    32 (the ImageNet checkpoint).

    - ``model(x, t, type_t="timestep")``: the predicted noise and learned
      variance channels at integer timesteps ``t``, ``x`` in [-1, 1].
    - ``model(x, sigma)`` (``type_t="noise_level"``): ``x`` in [0, 1]
      denoised at noise level ``sigma``, the timestep looked up.

    :param pretrained: a guided-diffusion checkpoint (``.pt``/``.pth``/
        ``.npz``) whose names are the module's.
    :param generator: CPU ``torch.Generator`` of the initialization (normal
        over ``sqrt(fan_in)``, the zero modules at zero, norms at one).
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, large_model: bool = False,
                 pretrained=None, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        if large_model:
            mc, nrb, attn_res = 256, 2, (8, 16, 32)
        else:
            mc, nrb, attn_res = 128, 1, (16,)
        self.model_channels = mc
        self.num_res_blocks = nrb
        self.attn_ds = tuple(256 // r for r in attn_res)
        self.channel_mult = (1, 1, 2, 2, 4, 4)
        self.in_channels = in_channels
        self.out_channels = 6 if out_channels == 3 else out_channels
        self._image_channels = out_channels
        self.num_head_channels = 64
        self._plan = self._build_plan()
        emb = 4 * mc
        self.time_embed = _Seq({0: _Affine((emb, mc), (emb,)), 2: _Affine((emb, emb), (emb,))})
        self.input_blocks = nn.ModuleList([self._layers(ls, emb) for ls in self._plan["input"]])
        self.middle_block = self._layers(self._plan["middle"], emb)
        self.output_blocks = nn.ModuleList([self._layers(ls, emb) for ls in self._plan["output"]])
        ch = self._plan["out_ch"]
        self.out = _Seq({0: _norm(ch), 2: _conv(self.out_channels, ch, 3)})
        self._init_params(generator)
        # the denoising mode's tables (adm.py:123-126), float32 as numpy makes
        # them, held in float64 so that a bf16 autocast leaves them whole
        betas = np.linspace(0.1 / 1000, 20 / 1000, 1000, dtype=np.float32)
        ac = np.cumprod(1.0 - betas)
        self.register_buffer("sqrt_alphas_cumprod", torch.from_numpy(np.sqrt(ac).astype(
            np.float64)), persistent=False)
        self.register_buffer("sqrt_1m_alphas_cumprod", torch.from_numpy(np.sqrt(1 - ac).astype(
            np.float64)), persistent=False)
        if pretrained is not None:
            from .convert import load_torch_checkpoint

            self.load_torch_state_dict(load_torch_checkpoint(pretrained))
        self.to(device)

    def _build_plan(self):
        """The blocks as ``(kind, cin, cout)`` lists (adm.py:138)."""
        mc, nrb, cm = self.model_channels, self.num_res_blocks, self.channel_mult
        attn_ds = set(self.attn_ds)
        inp, out = [], []
        ch = mc * cm[0]
        inp.append([("conv", self.in_channels, ch)])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(cm):
            for _ in range(nrb):
                layers = [("res", ch, mult * mc)]
                ch = mult * mc
                if ds in attn_ds:
                    layers.append(("attn", ch, ch))
                inp.append(layers)
                chans.append(ch)
            if level != len(cm) - 1:
                inp.append([("res_down", ch, ch)])
                chans.append(ch)
                ds *= 2
        mid = [("res", ch, ch), ("attn", ch, ch), ("res", ch, ch)]
        for level, mult in reversed(list(enumerate(cm))):
            for i in range(nrb + 1):
                ich = chans.pop()
                layers = [("res", ch + ich, mc * mult)]
                ch = mc * mult
                if ds in attn_ds:
                    layers.append(("attn", ch, ch))
                if level and i == nrb:
                    layers.append(("res_up", ch, ch))
                    ds //= 2
                out.append(layers)
        return {"input": inp, "middle": mid, "output": out, "out_ch": ch}

    @staticmethod
    def _layers(layers, emb):
        mods = nn.ModuleList()
        for kind, cin, cout in layers:
            if kind == "conv":
                mods.append(_conv(cout, cin, 3))
            elif kind == "attn":
                mods.append(_Attn(cin))
            else:
                mods.append(_Res(cin, cout, emb))
        return mods

    def _init_params(self, generator):
        """adm.py:229: biases and the zero modules at zero, every 1-D weight
        (the norms) at one, the rest normal over ``sqrt(fan_in)``."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif p.dim() == 1:
                    p.fill_(1.0)
                elif "out_layers.3" in name or "proj_out" in name or name == "out.2.weight":
                    p.zero_()
                else:
                    fan_in = int(np.prod(p.shape[1:]))
                    p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(max(fan_in, 1)))

    def load_torch_state_dict(self, sd):
        """Copy a guided-diffusion state dict (``{name: array}``) into the
        module, in place (adm.py:248): every name of the module must be there
        at its shape; other names are ignored.

        :raises KeyError: if the checkpoint lacks a parameter.
        :raises ValueError: if a shape differs.
        """
        state = self.state_dict(keep_vars=True)
        for name, t in state.items():
            if name not in sd:
                raise KeyError(f"checkpoint is missing parameter {name}")
            shape = tuple(np.shape(sd[name]))
            if shape != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint shape {shape} != {tuple(t.shape)}")
        with torch.no_grad():
            for name, t in state.items():
                v = sd[name]
                v = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.asarray(v, np.float32))
                t.copy_(v.to(t.dtype))
        return self

    def jax_names(self) -> dict:
        """The JAX module's tree path of each tensor: its flat dict ``p``."""
        return {k: f"p.{k}" for k in self.state_dict()}

    # -- blocks --------------------------------------------------------------

    def _res(self, x, emb, m: _Res, mode=None):
        h = F.silu(_group_norm(x, m.in_layers[0]))
        if mode == "down":
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        elif mode == "up":
            h, x = (v.repeat_interleave(2, -2).repeat_interleave(2, -1) for v in (h, x))
        h = _conv2d(h, m.in_layers[2])
        scale, shift = _linear(F.silu(emb), m.emb_layers[1])[:, :, None, None].chunk(2, dim=1)
        h = _group_norm(h, m.out_layers[0]) * (1 + scale) + shift
        h = _conv2d(F.silu(h), m.out_layers[3])
        if hasattr(m, "skip_connection"):
            x = _conv2d(x, m.skip_connection, padding=0)
        return x + h

    def _attn(self, x, m: _Attn):
        B, C, H, W = x.shape
        d = self.num_head_channels
        nh = C // d
        xf = x.reshape(B, C, H * W)
        qkv = F.conv1d(_group_norm(xf, m.norm), m.qkv.weight.to(x.dtype), m.qkv.bias.to(x.dtype))
        # heads first, then q/k/v within a head (adm.py:293-294)
        q, k, v = qkv.reshape(B * nh, 3 * d, H * W).transpose(1, 2).chunk(3, dim=-1)
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, C, H * W)
        h = F.conv1d(a, m.proj_out.weight.to(x.dtype), m.proj_out.bias.to(x.dtype))
        return (xf + h).reshape(B, C, H, W)

    def _run_layers(self, h, emb, layers, mods):
        for (kind, _, _), m in zip(layers, mods):
            if kind == "conv":
                h = _conv2d(h, m)
            elif kind == "attn":
                h = self._attn(h, m)
            else:
                h = self._res(h, emb, m, {"res": None, "res_down": "down", "res_up": "up"}[kind])
        return h

    def forward_diffusion(self, x, timesteps):
        """The predicted noise (and learned variance) at integer
        ``timesteps`` (adm.py:316); ``x`` in [-1, 1], sides multiples of 32."""
        t = torch.as_tensor(timesteps, device=x.device).reshape(-1)
        t = t.expand(x.shape[0]) if t.shape[0] != x.shape[0] else t
        emb = _timestep_embedding(t, self.model_channels).to(x.dtype)
        emb = _linear(F.silu(_linear(emb, self.time_embed[0])), self.time_embed[2])
        hs, h = [], x
        for layers, mods in zip(self._plan["input"], self.input_blocks):
            h = self._run_layers(h, emb, layers, mods)
            hs.append(h)
        h = self._run_layers(h, emb, self._plan["middle"], self.middle_block)
        for layers, mods in zip(self._plan["output"], self.output_blocks):
            h = self._run_layers(torch.cat([h, hs.pop()], dim=1), emb, layers, mods)
        return _conv2d(F.silu(_group_norm(h, self.out[0])), self.out[2])

    def diffusion_inputs(self, x, sigma):
        """What :meth:`forward_denoise` gives the network for ``x`` in [0, 1]
        at ``sigma`` (adm.py:343-351), in float32: ``x`` rescaled to
        ``sqrt(alpha) (2x - 1)``, the rescaled noise level ``(B, 1, 1, 1)``
        and the timesteps, the ``argmin`` of ``|sqrt(1 - ac) - 2 sigma'|``."""
        B = x.shape[0]
        s = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1)
        s = s.expand(B) if s.shape[0] != B else s
        sigma = s.reshape(-1, 1, 1, 1)
        alpha = 1.0 / (1.0 + 4.0 * sigma ** 2)
        xs = torch.sqrt(alpha) * (2 * x.float() - 1)
        sigma = sigma * torch.sqrt(alpha)
        table = self.sqrt_1m_alphas_cumprod.float()
        t = torch.argmin((table[:, None] - 2 * sigma.reshape(1, B)).abs(), dim=0)
        return xs, sigma, t

    def forward_denoise(self, x, sigma):
        """Denoise ``x`` in [0, 1] at ``sigma`` (adm.py:341): the timestep is
        the ``argmin`` of ``|sqrt(1 - ac) - 2 sigma'|`` over the tables. The
        rescaling, the lookup and the clean estimate run in float32 whatever
        ``x``'s dtype (the estimate divides by ``sqrt(ac)``, down to 0.006), the
        network in ``x``'s."""
        xs, sigma, t = self.diffusion_inputs(x, sigma)
        noise_est = self.forward_diffusion(xs.to(x.dtype), t)[:, :self._image_channels].float()
        denom = self.sqrt_alphas_cumprod.float()[t].reshape(-1, 1, 1, 1)
        denoised = torch.clamp((xs - noise_est * sigma * 2) / denom, -1.0, 1.0)
        return ((denoised + 1) / 2).to(x.dtype)

    def forward_unet(self, x, sigma, class_labels=None, augment_labels=None):
        """The UNet with ``sigma`` as its conditioning scalar (adm.py:358);
        the labels are accepted and unused (no label embedding)."""
        return self.forward_diffusion(x, torch.as_tensor(sigma, device=x.device).reshape(-1))

    def forward(self, x, sigma, type_t: str = "noise_level", **kwargs):
        # wrap-pad the top and left to multiples of 32 (adm.py:367-378)
        ph, pw = (-x.shape[-2]) % 32, (-x.shape[-1]) % 32
        if ph or pw:
            x = pad_hw(x, ph, 0, pw, 0, "wrap")
        out = self.forward_diffusion(x, sigma) if type_t == "timestep" \
            else self.forward_denoise(x, sigma)
        return out[..., ph:, pw:]

"""Reconstruct Anything Model (port of deepinv_tpu/models/ram.py).

A measurement-conditioned UNet that works as a reconstructor,
``model(y, physics)``, and as a denoiser, ``model(y, sigma=..., gain=...)``.
Each residual block of the encoder and decoder has a branch that decodes its
features to image space, pushes them through the scaled normal operator of
the scale as Krylov embeddings ``[x, f² A_s^T A_s x, ...]`` (over a
:class:`~deepinv_tpu_torch.physics.LinearPhysicsMultiScaler`), concatenates
the measurement's embedding and re-encodes. The input is rescaled, realigned
by the physics' ``prox_l2`` at a per-sample ``gamma``, and padded to the
UNet's grid through a :class:`~deepinv_tpu_torch.physics.PhysicsCropper`.

The names of the module tree are the JAX module's; ``convert.ram_names``
maps them to upstream's (``m_down1.enc.0.PhysicsBlock.encoding_conv.head0.convin``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core import TensorList
from ..device import resolve_device
from ..physics.wrappers import LinearPhysicsMultiScaler, PhysicsCropper
from .base import Denoiser, Reconstructor, handle_sigma
from .layers import Conv2d, ConvTranspose2d
from .utils import resize_bilinear

__all__ = ["RAM", "krylov_embeddings"]


def krylov_embeddings(y, physics, factor, scale=0, v=None, N=4, x_init=None):
    """``cat[x, Kx, K^2 x, ...]`` (``N`` terms), ``K = factor² A_s^T A_s``
    (ram.py:35)."""
    x = y if x_init is None else x_init
    out = x_k = x
    for _ in range(N - 1):
        x_k = physics.A_adjoint_A(x_k, scale=scale) * factor ** 2
        if v is not None:
            x_k = x_k - v
        out = torch.cat([out, x_k], dim=1)
    return out


class HeadBlock(nn.Module):
    """A conv block with 1x1 skip branches (ram.py:50)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, bias=True, depth=2,
                 relu_in=False, skip_in=False, generator=None):
        super().__init__()
        g = generator
        pad = kernel_size // 2
        c = out_channels if depth < 2 else in_channels
        self.convin = Conv2d(in_channels, c, kernel_size, 1, pad, bias=bias, generator=g)
        self.zero_conv_skip = Conv2d(in_channels, c, 1, 1, 0, bias=False, generator=g)
        self.depth, self.relu_in, self.skip_in = depth, relu_in, skip_in
        self.convs1, self.convs2, self.skipconvs = nn.ModuleList(), nn.ModuleList(), \
            nn.ModuleList()
        for i in range(depth - 1):
            c_out = in_channels if i < depth - 2 else out_channels
            self.convs1.append(Conv2d(in_channels, in_channels, kernel_size, 1, pad, bias=bias,
                                      generator=g))
            self.convs2.append(Conv2d(in_channels, c_out, kernel_size, 1, pad, bias=bias,
                                      generator=g))
            self.skipconvs.append(Conv2d(in_channels, c_out, 1, 1, 0, bias=False, generator=g))

    def forward(self, x):
        if self.skip_in and self.relu_in:
            x = F.relu(self.convin(x)) + self.zero_conv_skip(x)
        elif self.skip_in:
            x = self.convin(x) + self.zero_conv_skip(x)
        else:
            x = self.convin(x)
        for c1, c2, sk in zip(self.convs1, self.convs2, self.skipconvs):
            x = c2(F.relu(c1(x))) + sk(x)
        return x


class Heads(nn.Module):
    """Encoding heads chosen by the input's channel count (ram.py:85)."""

    def __init__(self, in_channels_list, out_channels, depth=2, scale=1, bias=True,
                 mode="bilinear", c_mult=1, c_add=0, relu_in=False, skip_in=False,
                 generator=None):
        super().__init__()
        self.in_channels_list = [c * (c_mult + c_add) for c in in_channels_list]
        self.scale, self.mode = scale, mode
        self.heads = nn.ModuleList([
            HeadBlock(cin, out_channels, depth=depth, bias=bias, relu_in=relu_in,
                      skip_in=skip_in, generator=generator) for cin in self.in_channels_list])

    def forward(self, x):
        i = self.in_channels_list.index(x.shape[1])
        if self.scale != 1:
            x = resize_bilinear(x, (x.shape[-2] // self.scale, x.shape[-1] // self.scale))
        return self.heads[i](x)


class Tails(nn.Module):
    """Decoding tails chosen by the output's channel count (ram.py:110)."""

    def __init__(self, in_channels, out_channels_list, depth=2, scale=1, bias=True,
                 mode="bilinear", c_mult=1, relu_in=False, skip_in=False, generator=None):
        super().__init__()
        self.out_channels_list = list(out_channels_list)
        self.scale, self.mode = scale, mode
        self.tails = nn.ModuleList([
            HeadBlock(in_channels, cout * c_mult, depth=depth, bias=bias, relu_in=relu_in,
                      skip_in=skip_in, generator=generator) for cout in self.out_channels_list])

    def forward(self, x, out_channels):
        x = self.tails[self.out_channels_list.index(out_channels)](x)
        if self.scale != 1:
            x = resize_bilinear(x, (x.shape[-2] * self.scale, x.shape[-1] * self.scale))
        return x


class MeasCondBlock(nn.Module):
    """Measurement conditioning (ram.py:136): decode the features to image
    space, embed them through the scale's normal operator, concatenate the
    measurement's embedding and re-encode."""

    def __init__(self, out_channels=64, img_channels=None, decode_upscale=None, N=4,
                 depth_encoding=1, c_mult=1, generator=None):
        super().__init__()
        self.separate_head = isinstance(img_channels, list)
        self.N, self.c_mult = N, c_mult
        self.decode_upscale = decode_upscale
        self.decoding_conv = Tails(out_channels, img_channels, depth=1, scale=1, bias=False,
                                   c_mult=c_mult, generator=generator)
        self.encoding_conv = Heads(img_channels, out_channels, depth=depth_encoding, scale=1,
                                   bias=False, c_mult=c_mult * N, c_add=N, relu_in=False,
                                   skip_in=True, generator=generator)

    def forward(self, x, y, physics, img_channels, scale=1):
        dec = self.decoding_conv(x, img_channels)
        parts = [krylov_embeddings(None, physics, 2 ** scale, scale=scale, N=self.N,
                                   x_init=dec[:, img_channels * c: img_channels * (c + 1)])
                 for c in range(self.c_mult)]
        return F.relu(self.encoding_conv(torch.cat([y] + parts, dim=1)))


class RAMResBlock(nn.Module):
    """``x + conv2(relu(conv1 x)) + gain * emb``, ``emb`` the measurement
    conditioning of ``relu(conv1 x)`` (ram.py:168)."""

    def __init__(self, in_channels=64, out_channels=64, bias=True, img_channels=None,
                 decode_upscale=None, N=2, c_mult=2, depth_encoding=2, generator=None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, 1, 1, bias=bias, generator=generator)
        self.conv2 = Conv2d(out_channels, out_channels, 3, 1, 1, bias=bias, generator=generator)
        self.gain = nn.Parameter(torch.ones(1))
        self.PhysicsBlock = MeasCondBlock(out_channels=out_channels, c_mult=c_mult,
                                          img_channels=img_channels,
                                          decode_upscale=decode_upscale, N=N,
                                          depth_encoding=depth_encoding, generator=generator)

    def forward(self, x, physics=None, y=None, img_channels=None, scale=0):
        u = F.relu(self.conv1(x))
        emb = self.PhysicsBlock(u, y, physics, img_channels=img_channels, scale=scale)
        return x + self.conv2(u) + self.gain.to(x.dtype) * emb


class BaseEncBlock(nn.Module):
    """``nb`` conditioned residual blocks (ram.py:191)."""

    def __init__(self, in_channels, out_channels, bias=False, nb=4, img_channels=None,
                 decode_upscale=None, generator=None):
        super().__init__()
        self.enc = nn.ModuleList([
            RAMResBlock(in_channels, out_channels, bias=bias, img_channels=img_channels,
                        decode_upscale=decode_upscale, generator=generator) for _ in range(nb)])

    def forward(self, x, physics=None, y=None, img_channels=None, scale=0):
        for blk in self.enc:
            x = blk(x, physics=physics, y=y, img_channels=img_channels, scale=scale)
        return x


class InHead(nn.Module):
    """Input convs chosen by the channel count (ram.py:211)."""

    def __init__(self, in_channels_list, out_channels, bias=False, input_layer=False,
                 generator=None):
        super().__init__()
        self.in_channels_list = list(in_channels_list)
        self.input_layer = input_layer
        self.convs = nn.ModuleList([Conv2d(cin, out_channels, 3, 1, 1, bias=bias,
                                           generator=generator)
                                    for cin in self.in_channels_list])

    def forward(self, x):
        cin = x.shape[1] - 1 if self.input_layer else x.shape[1]
        return self.convs[self.in_channels_list.index(cin)](x)


class OutTail(nn.Module):
    """Output convs chosen by the channel count (ram.py:230)."""

    def __init__(self, in_channels, out_channels_list, bias=False, generator=None):
        super().__init__()
        self.out_channels_list = list(out_channels_list)
        self.convs = nn.ModuleList([Conv2d(in_channels, cout, 3, 1, 1, bias=bias,
                                           generator=generator)
                                    for cout in self.out_channels_list])

    def forward(self, x, out_channels):
        return self.convs[self.out_channels_list.index(out_channels)](x)


def _as(v, like):
    """``v`` as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


class RAM(Reconstructor, Denoiser):
    """Reconstruct Anything Model (ram.py:246).

    :param in_channels: the channel counts the heads serve.
    :param nc: the UNet's widths by scale.
    :param nb: residual blocks a stage.
    :param pretrained: upstream's ``ram.pth.tar`` (a torch state dict).
    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: Sequence[int] = (1, 2, 3), nc=(64, 128, 256, 512),
                 nb: int = 4, pretrained=None, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        nc = tuple(nc)
        in_channels = list(in_channels)
        self.in_channels = in_channels
        self.separate_head = True
        self.nb = nb
        self.fact_realign = nn.Parameter(torch.ones(1))
        self.m_head = InHead([ch + 2 for ch in in_channels], nc[0], generator=g)

        def enc(c, upscale):
            return BaseEncBlock(c, c, nb=nb, img_channels=in_channels, decode_upscale=upscale,
                                generator=g)

        self.m_down1 = enc(nc[0], 1)
        self.m_down2 = enc(nc[1], 2)
        self.m_down3 = enc(nc[2], 4)
        self.m_body = enc(nc[3], 8)
        self.m_up3 = enc(nc[2], 4)
        self.m_up2 = enc(nc[1], 2)
        self.m_up1 = enc(nc[0], 1)
        self.pool1 = Conv2d(nc[0], nc[1], 2, 2, 0, bias=False, generator=g)
        self.pool2 = Conv2d(nc[1], nc[2], 2, 2, 0, bias=False, generator=g)
        self.pool3 = Conv2d(nc[2], nc[3], 2, 2, 0, bias=False, generator=g)
        self.up3 = ConvTranspose2d(nc[3], nc[2], 2, 2, 0, bias=False, generator=g)
        self.up2 = ConvTranspose2d(nc[2], nc[1], 2, 2, 0, bias=False, generator=g)
        self.up1 = ConvTranspose2d(nc[1], nc[0], 2, 2, 0, bias=False, generator=g)
        self.m_tail = OutTail(nc[0], in_channels, generator=g)
        self.sigma_threshold = 5e-3
        self.gain_threshold = 1e-4
        if pretrained is not None:
            from .convert import load_torch_checkpoint, port_ram

            port_ram(self, load_torch_checkpoint(pretrained))
        self.to(device)

    # -- conditioning (ram.py:301-327) ----------------------------------------

    def constant2map(self, value, x):
        """A scalar or per-sample value as a ``(B, 1, H, W)`` map (ram.py:301)."""
        v = torch.as_tensor(0.0 if value is None else value, dtype=x.dtype,
                            device=x.device).reshape(-1)
        v = v[:x.shape[0]] if v.shape[0] > 1 else v.expand(x.shape[0])
        return v[:, None, None, None].expand((x.shape[0], 1) + tuple(x.shape[-2:]))

    def base_conditioning(self, x, sigma, gain):
        nmap = handle_sigma(0.0 if sigma is None else sigma, x)
        gmap = handle_sigma(0.0 if gain is None else gain, x)
        return torch.cat([x, nmap, gmap], dim=1)

    def realign_input(self, x, physics, y, sigma):
        """``physics.prox_l2(x, y, gamma)`` at the per-sample ``gamma`` of
        the measurement's SNR (ram.py:315)."""
        f = getattr(physics, "factor", 1.0)
        y0 = y[0] if isinstance(y, TensorList) else y
        num = y0.reshape(y0.shape[0], -1).abs().mean(dim=1)
        s = torch.as_tensor(0.0 if sigma is None else sigma, dtype=num.dtype, device=num.device)
        snr = num / ((s.amax(dim=(1, 2, 3)) if s.dim() == 4 else s) + 1e-4)
        gamma = 1.0 / (1e-4 + 1.0 / (snr * f ** 2))
        gamma = gamma.reshape((x.shape[0],) + (1,) * (x.dim() - 1)) \
            * self.fact_realign.to(gamma.dtype)
        return physics.prox_l2(x, y, gamma=gamma.clamp_min(1e-8))

    def forward_unet(self, x0, sigma=None, gain=None, physics=None, y=None):
        """The UNet on the back-projection ``x0`` (ram.py:329)."""
        img_channels = x0.shape[1]
        physics = LinearPhysicsMultiScaler(physics, tuple(x0.shape[-3:]), device=x0.device)
        y_list = [krylov_embeddings(physics.downsample(x0, scale=s), physics, 2 ** s, scale=s,
                                    N=2) for s in range(4)]
        if self.separate_head and img_channels not in self.in_channels:
            raise ValueError(f"Input image has {img_channels} channels, but the network only "
                             f"has heads for {self.in_channels} channels.")
        if y is not None:
            x0 = self.realign_input(x0, physics, y, sigma)
        x0 = self.base_conditioning(x0, sigma, gain)
        x1 = self.m_head(x0)
        x1_ = self.m_down1(x1, physics, y_list[0], img_channels, 0)
        x2 = self.pool1(x1_)
        x3_ = self.m_down2(x2, physics, y_list[1], img_channels, 1)
        x3 = self.pool2(x3_)
        x4_ = self.m_down3(x3, physics, y_list[2], img_channels, 2)
        x4 = self.pool3(x4_)
        x = self.m_body(x4, physics, y_list[3], img_channels, 3)
        x = self.m_up3(self.up3(x + x4), physics, y_list[2], img_channels, 2)
        x = self.m_up2(self.up2(x + x3), physics, y_list[1], img_channels, 1)
        x = self.m_up1(self.up1(x + x2), physics, y_list[0], img_channels, 0)
        return self.m_tail(x + x1, img_channels)

    def get_pad(self, img_size):
        """The pads to the UNet's grid: multiples of 16, at least 64
        (ram.py:365)."""
        pad = (0, -img_size[-2] % 16, -img_size[-1] % 16)
        if img_size[-2] + pad[1] < 64:
            pad = (pad[0], 64 - img_size[-2], pad[2])
        if img_size[-1] + pad[2] < 64:
            pad = (pad[0], pad[1], 64 - img_size[-1])
        return pad

    def obtain_sigma_gain(self, physics, sigma, gain, rescale_val):
        """sigma and gain from the arguments or the physics' noise model,
        over ``rescale_val`` (ram.py:377)."""
        nm = getattr(physics, "noise_model", None)

        def resolve(v, attr, floor):
            if v is None:
                if nm is not None and getattr(nm, attr, None) is not None:
                    return _as(getattr(nm, attr), rescale_val) / rescale_val
                return floor * torch.ones_like(rescale_val)
            v = _as(v, rescale_val)
            return v / rescale_val.reshape(-1, 1, 1, 1) if v.dim() == 4 else v / rescale_val

        return resolve(sigma, "sigma", self.sigma_threshold), \
            resolve(gain, "gain", self.gain_threshold)

    def forward(self, y, physics=None, sigma=None, gain=None, img_size=None, **kwargs):
        if physics is None and sigma is None and gain is None:
            raise ValueError("Either physics, sigma or gain must be provided to the RAM model.")
        y0 = y[0] if isinstance(y, TensorList) else y
        B = y0.shape[0]
        max_val = y0.reshape(B, -1).abs().amax(dim=1)
        max_val = torch.where(max_val == 0, torch.full_like(max_val, 1e-12), max_val)
        rescale_val = torch.where(max_val > 5 * self.sigma_threshold,
                                  torch.ones_like(max_val), max_val)

        def rescaled(v):
            return v / rescale_val.reshape((B,) + (1,) * (v.dim() - 1))

        y = TensorList([rescaled(v) for v in y]) if isinstance(y, TensorList) else rescaled(y)
        if physics is None:
            from ..physics import Denoising, ZeroNoise

            physics = Denoising(noise_model=ZeroNoise())
        if img_size is None:
            for attr in ("img_shape", "img_size", "imsize"):
                img_size = getattr(physics, attr, None)
                if img_size is not None:
                    break
            if img_size is None:
                img_size = physics.A_adjoint(y).shape[1:]
        pad = self.get_pad(img_size)
        sigma, gain = self.obtain_sigma_gain(physics, sigma, gain, rescale_val)
        use_pad = any(p != 0 for p in pad)
        if use_pad:
            physics = PhysicsCropper(physics, pad)
        x_in = physics.A_adjoint(y)
        sigma = sigma.clamp_min(self.sigma_threshold)
        # A 4-D sigma or gain map is padded on the swapped axes, bug for bug
        # with the checkpoint's reference (ram.py:450-465): pad[0] (the
        # channels', always 0) lands on H and pad[1] (H's) on W.
        if sigma.dim() == 4:
            sigma = F.pad(sigma, (pad[1], 0, pad[0], 0), value=self.sigma_threshold)
        gain = gain.clamp_min(self.gain_threshold)
        if gain.dim() == 4:
            gain = F.pad(gain, (pad[1], 0, pad[0], 0), value=self.gain_threshold)
        out = self.forward_unet(x_in, sigma=sigma, gain=gain, physics=physics, y=y)
        if use_pad:
            out = physics.remove_pad(out)
        return out * rescale_val.reshape((B,) + (1,) * (out.dim() - 1))

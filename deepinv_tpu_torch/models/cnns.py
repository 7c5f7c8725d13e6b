"""CNN denoisers and reconstructors: FFDNet, SRResNet, AutoEncoder, DScCP
(port of deepinv_tpu/models/cnns.py)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device
from .base import Denoiser, Reconstructor, handle_sigma
from .convert import load_torch_checkpoint, port_dsccp, port_srresnet
from .layers import BatchNorm2d, Conv2d, Linear, PixelShuffle, he_init

__all__ = ["FFDNet", "SRResNet", "AutoEncoder", "DScCP", "PReLU"]


class FFDNet(Denoiser):
    """FFDNet (cnns.py:19): pixel-unshuffle by 2, the noise map as one more
    channel, ``depth`` convs with ReLU between them, pixel-shuffle back. The
    hidden convs are plain layers, as in the JAX package, which does not
    send them to the chain kernel.

    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, nf: int = 64,
                 depth: int = 15, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        layers = [Conv2d(in_channels * 4 + 1, nf, 3, 1, 1, generator=g)]
        layers += [Conv2d(nf, nf, 3, 1, 1, generator=g) for _ in range(depth - 2)]
        layers.append(Conv2d(nf, out_channels * 4, 3, 1, 1, generator=g))
        self.layers = nn.ModuleList(layers)
        self.to(device)

    def forward(self, x, sigma=0.05, **kwargs):
        H, W = x.shape[-2:]
        xp = F.pad(x, (0, W % 2, 0, H % 2), mode="replicate")
        u = F.pixel_unshuffle(xp, 2)
        h = torch.cat([u, handle_sigma(sigma, u)], dim=1)
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < len(self.layers) - 1:
                h = F.relu(h)
        return F.pixel_shuffle(h, 2)[..., :H, :W]


class PReLU(nn.Module):
    """``max(0, x) + w min(0, x)``, one shared slope by default (cnns.py:61)."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def forward(self, x):
        w = self.weight if self.weight.shape[0] == 1 else self.weight[None, :, None, None]
        return x.clamp_min(0) + w * x.clamp_max(0)


class _InstanceNorm2d(nn.Module):
    """Per-instance, per-channel normalization without affine (cnns.py:74)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        mu = x.mean((2, 3), keepdim=True)
        var = x.var((2, 3), keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + self.eps)


class _LayerNorm2d(nn.Module):
    """Normalization over the channels at each pixel, with affine (cnns.py:86)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        x = (x - mu) / torch.sqrt(var + self.eps)
        return self.weight[None, :, None, None] * x + self.bias[None, :, None, None]


class _Identity(nn.Module):
    def __init__(self, num_features: int = 0):
        super().__init__()

    def forward(self, x):
        return x


_SR_NORMS = {"batch_norm": BatchNorm2d, "instance_norm": _InstanceNorm2d,
             "layer_norm": _LayerNorm2d, None: _Identity}


class _SRBlock(nn.Module):
    """Conv-norm-PReLU-conv-norm residual block (cnns.py:113)."""

    def __init__(self, feats: int, norm, generator=None):
        super().__init__()
        self.conv1 = Conv2d(feats, feats, 3, 1, 1, generator=generator)
        self.n1 = _SR_NORMS[norm](feats)
        self.act = PReLU()
        self.conv2 = Conv2d(feats, feats, 3, 1, 1, generator=generator)
        self.n2 = _SR_NORMS[norm](feats)

    def forward(self, x):
        return x + self.n2(self.conv2(self.act(self.n1(self.conv1(x)))))


class SRResNet(Reconstructor):
    """SRResNet super-resolution network (cnns.py:128).

    :param norm: ``"batch_norm"``, ``"instance_norm"``, ``"layer_norm"`` or None.
    :param final_relu: clamp the output at 0.
    :param pretrained: upstream weights (a path or a state dict), through
        :func:`~deepinv_tpu_torch.models.convert.srresnet_names`.
    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, num_blocks: int = 16, im_c: int = 3, feats: int = 64, upscale: int = 4,
                 norm="batch_norm", final_kernel_size: int = 9, final_relu: bool = False,
                 pretrained=None, generator=None, device=None):
        if upscale < 1 or (upscale & (upscale - 1)) != 0:
            raise ValueError(f"upscale must be a power of two, got {upscale}")
        if final_kernel_size % 2 == 0:
            raise ValueError(f"final_kernel_size must be odd, got {final_kernel_size}")
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.fe_conv = Conv2d(im_c, feats, 9, 1, 4, generator=g)
        self.fe_act = PReLU()
        self.blocks = nn.ModuleList([_SRBlock(feats, norm, g) for _ in range(num_blocks)])
        self.block_conv = Conv2d(feats, feats, 3, 1, 1, generator=g)
        self.block_norm = _SR_NORMS[norm](feats)
        n_up = int(math.log2(upscale))
        self.up_convs = nn.ModuleList([Conv2d(feats, feats * 4, 3, 1, 1, generator=g)
                                       for _ in range(n_up)])
        self.up_acts = nn.ModuleList([PReLU() for _ in range(n_up)])
        self.shuffle = PixelShuffle(2)
        self.final_conv = Conv2d(feats, im_c, final_kernel_size, 1, (final_kernel_size - 1) // 2,
                                 generator=g)
        self.final_relu = final_relu
        if pretrained is not None:
            port_srresnet(self, load_torch_checkpoint(pretrained))
        self.to(device)

    def forward(self, y, physics=None, **kwargs):
        lf = self.fe_act(self.fe_conv(y))
        x = lf
        for b in self.blocks:
            x = b(x)
        x = lf + self.block_norm(self.block_conv(x))
        for conv, act in zip(self.up_convs, self.up_acts):
            x = act(self.shuffle(conv(x)))
        x = self.final_conv(x)
        return F.relu(x) if self.final_relu else x


class AutoEncoder(Denoiser):
    """Fully-connected autoencoder on the flattened image (cnns.py:182).

    :param generator: CPU ``torch.Generator`` of the uniform initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, dim_input: int, dim_hid: int = 512, dim_mid: int = 128,
                 residual: bool = True, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.enc1 = Linear(dim_input, dim_hid, generator=g)
        self.enc2 = Linear(dim_hid, dim_mid, generator=g)
        self.dec1 = Linear(dim_mid, dim_hid, generator=g)
        self.dec2 = Linear(dim_hid, dim_input, generator=g)
        self.residual = residual
        self.to(device)

    def forward(self, x, sigma=None, **kwargs):
        v = x.reshape(x.shape[0], -1)
        out = self.dec2(F.relu(self.dec1(F.relu(self.enc2(F.relu(self.enc1(v)))))))
        if self.residual:
            out = out + v
        return out.reshape(x.shape)


class DScCP(Denoiser):
    """Deep strongly-convex Chambolle-Pock denoiser (cnns.py:208): ``depth``
    unrolled accelerated CP steps, each with one conv kernel tied between the
    analysis conv and its transposed synthesis, a per-layer ``mu`` and a
    stepsize from a 50-step power method on ``K^T K``.

    Each power method starts from a normal draw of the input's shape. The JAX
    package draws it from ``jax.random`` (cnns.py:246); the port from the
    call's ``generator`` (one seeded 0 on the input's device where it is
    None), or takes the ``depth`` starts by ``draws=`` (ROADMAP queue 3).

    :param pretrained: upstream weights (a path or a state dict), through
        :func:`~deepinv_tpu_torch.models.convert.dsccp_names`.
    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, depth: int = 20, n_channels_per_layer: int = 64, in_channels: int = 3,
                 pretrained=None, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        nf = n_channels_per_layer
        self.weights = nn.ParameterList([
            nn.Parameter(he_init((nf, in_channels, 3, 3), in_channels * 9, generator))
            for _ in range(depth)])
        self.depth = depth
        self.mu = nn.Parameter(torch.ones(depth))
        self.power_iters = 50
        if pretrained is not None:
            port_dsccp(self, load_torch_checkpoint(pretrained))
        self.to(device)

    @staticmethod
    def _analysis(w, x):
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def _synthesis(w, u):
        return F.conv_transpose2d(u, w, padding=1)

    def _op_norm(self, w, x0):
        """``||K^T K||`` by ``power_iters`` power steps from ``x0``
        (cnns.py:244)."""
        xt = x0 / x0.norm()
        val = x0.new_ones(())
        for _ in range(self.power_iters):
            xt = self._synthesis(w, self._analysis(w, xt))
            val = xt.norm()
            xt = xt / val
        return val

    def forward(self, x, sigma=0.03, generator=None, draws=None, **kwargs):
        rng = Draws.of(generator, seed=0, draws=draws, device=x.device)
        sig = handle_sigma(sigma, x)[:, :, :1, :1]
        x_prev = x_curr = x
        u = self._analysis(self.weights[0], x)
        gamma = 1.0
        for k in range(self.depth):
            w, mu = self.weights[k], self.mu[k]
            tau = 0.99 / self._op_norm(w, rng.normal(tuple(x.shape), x.dtype))
            # the relaxation coefficient takes no gradient of mu (cnns.py:271-275)
            alphak = 1.0 / torch.sqrt(1 + 2 * gamma * mu.detach())
            u_ = u + tau / mu * self._analysis(w, (1 + alphak) * x_curr - alphak * x_prev)
            u = torch.minimum(torch.maximum(u_, -(sig ** 2)), sig ** 2)
            x_ = (mu / (mu + 1)) * x + (1 / (1 + mu)) * x_curr \
                - (mu / (mu + 1)) * self._synthesis(w, u)
            x_prev, x_curr = x_curr, x_.clamp(0.0, 1.0)
        return x_curr

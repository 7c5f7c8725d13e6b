"""GAN architectures (port of deepinv_tpu/models/gan.py): the PatchGAN, ESRGAN
and DCGAN discriminators, the DCGAN generator and the CSGM reconstructor.

A JAX layer list of ``(conv, norm)`` pairs (``None`` where a layer has no
norm) is an ``nn.ModuleList`` of ``nn.ModuleList``s here, so that the state
dict's names are the JAX tree paths (``layers.1.0.weight`` the conv,
``layers.1.1.running_var`` its norm) and weights cross by
:func:`~deepinv_tpu_torch.models.convert.load_jax_params`. The norms are
:class:`~deepinv_tpu_torch.models.layers.BatchNorm2d`: inference mode with
four trained tensors, as the JAX package trains every leaf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device
from .base import Reconstructor
from .layers import BatchNorm2d, Conv2d, ConvTranspose2d

__all__ = ["PatchGANDiscriminator", "ESRGANDiscriminator", "DCGANGenerator",
           "DCGANDiscriminator", "CSGMGenerator"]


def _pairs(pairs) -> nn.ModuleList:
    """``[(layer, norm or None), ...]`` as a ModuleList of ModuleLists."""
    return nn.ModuleList(nn.ModuleList([a] if b is None else [a, b]) for a, b in pairs)


def _conv_norm_lrelu(pairs, h):
    for pair in pairs:
        for layer in pair:
            h = layer(h)
        h = F.leaky_relu(h, 0.2)
    return h


class PatchGANDiscriminator(nn.Module):
    """The 70x70 PatchGAN (gan.py:23): a stride-2 4x4 conv, ``n_layers - 1``
    more with a norm, a stride-1 conv with a norm, leaky ReLUs of slope 0.2,
    and a 4x4 conv to one channel.

    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, generator=None,
                 device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        pairs = [(Conv2d(input_nc, ndf, 4, 2, 1, generator=g), None)]
        nf = ndf
        for _ in range(1, n_layers):
            nxt = min(nf * 2, 512)
            pairs.append((Conv2d(nf, nxt, 4, 2, 1, generator=g), BatchNorm2d(nxt)))
            nf = nxt
        nxt = min(nf * 2, 512)
        pairs.append((Conv2d(nf, nxt, 4, 1, 1, generator=g), BatchNorm2d(nxt)))
        self.layers = _pairs(pairs)
        self.final = Conv2d(nxt, 1, 4, 1, 1, generator=g)
        self.to(device)

    def forward(self, x):
        return self.final(_conv_norm_lrelu(self.layers, x))


class ESRGANDiscriminator(nn.Module):
    """The VGG-style discriminator of ESRGAN (gan.py:49): eight 3x3 convs,
    strides alternating 1 and 2, norms after the first, leaky ReLUs, and a
    3x3 conv to one channel.

    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, input_shape=(3, 128, 128), generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        C = input_shape[0]
        cfg = [(C, 64, 1), (64, 64, 2), (64, 128, 1), (128, 128, 2), (128, 256, 1),
               (256, 256, 2), (256, 512, 1), (512, 512, 2)]
        self.convs = _pairs((Conv2d(cin, cout, 3, s, 1, generator=g),
                             BatchNorm2d(cout) if i > 0 else None)
                            for i, (cin, cout, s) in enumerate(cfg))
        self.final = Conv2d(512, 1, 3, 1, 1, generator=g)
        self.to(device)

    def forward(self, x):
        return self.final(_conv_norm_lrelu(self.convs, x))


class DCGANGenerator(nn.Module):
    """The DCGAN generator, latent ``(B, nz)`` to a 64x64 image in (-1, 1)
    (gan.py:74): four transposed convs with norms and ReLUs, a last one and
    a tanh.

    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, output_size: int = 64, nz: int = 100, ngf: int = 64, nc: int = 3,
                 generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.nz = nz
        self.net = _pairs([
            (ConvTranspose2d(nz, ngf * 8, 4, 1, 0, bias=False, generator=g), BatchNorm2d(ngf * 8)),
            (ConvTranspose2d(ngf * 8, ngf * 4, 4, 2, 1, bias=False, generator=g),
             BatchNorm2d(ngf * 4)),
            (ConvTranspose2d(ngf * 4, ngf * 2, 4, 2, 1, bias=False, generator=g),
             BatchNorm2d(ngf * 2)),
            (ConvTranspose2d(ngf * 2, ngf, 4, 2, 1, bias=False, generator=g), BatchNorm2d(ngf)),
        ])
        self.final = ConvTranspose2d(ngf, nc, 4, 2, 1, bias=False, generator=g)
        self.to(device)

    def forward(self, z):
        h = z.reshape(z.shape[0], self.nz, 1, 1)
        for conv, bn in self.net:
            h = F.relu(bn(conv(h)))
        return torch.tanh(self.final(h))


class DCGANDiscriminator(nn.Module):
    """The DCGAN discriminator (gan.py:96): four stride-2 4x4 convs, norms
    after the first, leaky ReLUs, and a 4x4 conv to one value.

    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, ndf: int = 64, nc: int = 3, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator
        self.net = _pairs([
            (Conv2d(nc, ndf, 4, 2, 1, bias=False, generator=g), None),
            (Conv2d(ndf, ndf * 2, 4, 2, 1, bias=False, generator=g), BatchNorm2d(ndf * 2)),
            (Conv2d(ndf * 2, ndf * 4, 4, 2, 1, bias=False, generator=g), BatchNorm2d(ndf * 4)),
            (Conv2d(ndf * 4, ndf * 8, 4, 2, 1, bias=False, generator=g), BatchNorm2d(ndf * 8)),
        ])
        self.final = Conv2d(ndf * 8, 1, 4, 1, 0, bias=False, generator=g)
        self.to(device)

    def forward(self, x):
        return self.final(_conv_norm_lrelu(self.net, x))


class CSGMGenerator(Reconstructor):
    """Compressed sensing with a generative model (gan.py:120): the latent
    ``z`` is fitted so that ``A(G(z))`` matches ``y``, and ``G(z)`` returned.

    :param backbone_generator: the generator ``G`` (its ``nz`` the latent's
        width).
    :param inf_max_iter: latent steps.
    :param inf_lr: their step size.
    :param inf_tol: kept for the JAX signature; the JAX loop runs every step.
    """

    def __init__(self, backbone_generator, inf_max_iter: int = 100, inf_lr: float = 1e-2,
                 inf_tol: float = 1e-4):
        super().__init__()
        self.G = backbone_generator
        self.inf_max_iter = inf_max_iter
        self.inf_lr = inf_lr
        self.inf_tol = inf_tol

    def _device(self):
        return next(self.G.parameters()).device

    def random_latent(self, generator=None, batch_size: int = 1):
        """A latent uniform on [-1, 1], ``(batch_size, nz)`` (gan.py:127),
        from ``generator`` (one seeded 0 where None)."""
        rng = Draws.of(generator, seed=0, device=self._device())
        return rng.uniform((batch_size, self.G.nz)) * 2 - 1

    def optimize_z(self, z, y, physics):
        """``inf_max_iter`` heavy-ball steps on ``||A(G(z)) - y||^2``
        (gan.py:138-154): ``m = 0.9 m + grad``, ``z = z - inf_lr m``. Each
        gradient is taken with respect to ``z`` alone; ``G``'s weights get no
        gradient and do not change."""
        z = z.detach()
        m = torch.zeros_like(z)
        with torch.enable_grad():
            for _ in range(self.inf_max_iter):
                zz = z.requires_grad_()
                loss = (physics.A(self.G(zz)) - y).abs().pow(2).sum()
                (g,) = torch.autograd.grad(loss, zz)
                m = 0.9 * m + g
                z = (zz - self.inf_lr * m).detach()
        return z

    def forward(self, y, physics, generator=None, z0=None, **kwargs):
        """``G`` at the latent fitted from ``z0``, a standard normal
        ``(B, nz)`` drawn from ``generator`` (one seeded 0 where None) unless
        given (gan.py:156)."""
        if z0 is None:
            z0 = Draws.of(generator, seed=0, device=y.device).normal((y.shape[0], self.G.nz))
        z = self.optimize_z(z0, y, physics)
        with torch.no_grad():
            return self.G(z)

"""Deep Image Prior and its ConvDecoder (port of deepinv_tpu/models/dip.py).

An untrained reconstruction: the weights of a decoder are fitted so that
``A(G_w(z))`` matches ``y``, by Adam. The JAX call is functional: it starts
from the module's weights every time and leaves them as they are
(dip.py:72-93). The port fits a copy, so the module's weights do not change
either.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device
from .base import Reconstructor
from .layers import Conv2d

__all__ = ["ConvDecoder", "DeepImagePrior"]


def resize_nearest(h, size):
    """``jax.image.resize(h, (..., H, W), "nearest")`` of the last two axes:
    source index ``floor((i + 0.5) * m / n)`` computed in float32 as JAX
    computes it (``jax/_src/image/scale.py`` ``_resize_nearest``), on the host,
    so that every device takes the same pixels. ``F.interpolate``'s
    ``"nearest-exact"`` samples the same half-pixel centres, but on a CUDA
    device it multiplies by the rounded ratio and can round an exact integer
    down: 4 -> 51 takes source 1 for output 25, not 2."""
    for axis, n in ((-2, int(size[0])), (-1, int(size[1]))):
        m = h.shape[axis]
        if m != n:
            idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
                           / np.float32(n)).astype(np.int64)
            h = h.index_select(axis, torch.from_numpy(idx).to(h.device))
    return h


class ConvDecoder(nn.Module):
    """Convolutional decoder, latent to image (dip.py:21): ``layers`` times a
    nearest-neighbour resize toward the image's size, a 3x3 conv, a ReLU and
    a per-channel normalization with a learned affine; then a 1x1 conv and a
    sigmoid.

    ``jax.image.resize(..., "nearest")`` samples at half-pixel centres
    (dip.py:47): :func:`resize_nearest`, not ``F.interpolate``'s
    ``"nearest"``, which differs where the size does not divide evenly.

    :param generator: CPU ``torch.Generator`` of the He-normal initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, img_shape, in_size=(4, 4), channels: int = 64, layers: int = 5,
                 generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        C_out = img_shape[0]
        self.in_size = tuple(in_size)
        self.channels = channels
        self.convs = nn.ModuleList(Conv2d(channels, channels, 3, 1, 1, generator=generator)
                                   for _ in range(layers))
        self.gammas = nn.ParameterList(nn.Parameter(torch.ones(1, channels, 1, 1))
                                       for _ in range(layers))
        self.betas = nn.ParameterList(nn.Parameter(torch.zeros(1, channels, 1, 1))
                                      for _ in range(layers))
        self.out_conv = Conv2d(channels, C_out, 1, 1, 0, generator=generator)
        self.img_shape = tuple(img_shape)
        self.n_up = layers
        self.to(device)

    def forward(self, z):
        h = z
        H, W = self.img_shape[1:]
        for i, conv in enumerate(self.convs):
            th = max(self.in_size[0], int(round(H * (i + 1) / self.n_up)))
            tw = max(self.in_size[1], int(round(W * (i + 1) / self.n_up)))
            h = F.relu(conv(resize_nearest(h, (th, tw))))
            # jnp.std is the population deviation (dip.py:51)
            mu = h.mean((2, 3), keepdim=True)
            sd = h.std((2, 3), correction=0, keepdim=True) + 1e-5
            h = self.gammas[i] * (h - mu) / sd + self.betas[i]
        return torch.sigmoid(self.out_conv(h))

    def latent_shape(self, batch: int = 1):
        return (batch, self.channels) + self.in_size


class DeepImagePrior(Reconstructor):
    """DIP reconstruction (dip.py:59): ``iterations`` Adam steps (``lr``) on
    ``sum |A(G(z)) - y|^2`` over a copy of the decoder's weights, from a
    latent ``z`` of 0.1 times a standard normal.

    :param generator: the decoder network (default ``ConvDecoder(img_shape)``),
        the JAX package's name for it; the random draw of a call comes from
        the ``generator=`` of :meth:`forward`, a ``torch.Generator``.
    :param device: where the default decoder goes, the CUDA device by default.
    """

    def __init__(self, generator=None, img_shape=(1, 64, 64), iterations: int = 1000,
                 lr: float = 1e-2, verbose: bool = False, device=None):
        super().__init__()
        self.generator = generator if generator is not None else ConvDecoder(img_shape,
                                                                             device=device)
        self.iterations = iterations
        self.lr = lr

    def forward(self, y, physics, generator=None, z=None, **kwargs):
        """The fitted decoder's image. ``z`` is drawn from ``generator`` (a
        ``torch.Generator``, one seeded 0 where None) unless given."""
        if z is None:
            rng = Draws.of(generator, seed=0, device=y.device)
            z = rng.normal(self.generator.latent_shape(y.shape[0])) * 0.1
        net = copy.deepcopy(self.generator)
        opt = torch.optim.Adam(net.parameters(), lr=self.lr)
        with torch.enable_grad():
            for _ in range(self.iterations):
                opt.zero_grad(set_to_none=True)
                (physics.A(net(z)) - y).abs().pow(2).sum().backward()
                opt.step()
        with torch.no_grad():
            return net(z)

"""Poisson2Sparse and its ConvLista (port of deepinv_tpu/models/poisson2sparse.py).

ConvLista is an unrolled convolutional ISTA with learned analysis and
synthesis dictionaries and soft thresholds. Poisson2Sparse fits it, self
supervised, on the one noisy image it denoises: a neighbour loss between
two pixels of each 2x2 cell plus an l1 sparsity of the code. As in the JAX
call (poisson2sparse.py:77-103), each call fits a copy of the network and
leaves the module's weights as they are.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device
from .base import Denoiser
from .layers import Conv2d

__all__ = ["ConvLista", "Poisson2Sparse"]


class ConvLista(nn.Module):
    """Unrolled convolutional ISTA (poisson2sparse.py:21): the dictionaries
    start at 0.1 times their He-normal draw, the thresholds ``theta`` at 0.01
    and the skip gain ``alpha`` at 1.

    :param generator: CPU ``torch.Generator`` of the initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, in_channels: int = 1, n_filters: int = 64, kernel_size: int = 5,
                 n_iter: int = 10, generator=None, device=None):
        device = resolve_device(device)
        super().__init__()
        p = kernel_size // 2
        self.We = Conv2d(in_channels, n_filters, kernel_size, 1, p, bias=False, generator=generator)
        self.Wd = Conv2d(n_filters, in_channels, kernel_size, 1, p, bias=False, generator=generator)
        self.Wg = Conv2d(in_channels, n_filters, kernel_size, 1, p, bias=False, generator=generator)
        with torch.no_grad():
            for conv in (self.We, self.Wd, self.Wg):
                conv.weight.mul_(0.1)
        self.theta = nn.Parameter(torch.full((n_iter, 1, n_filters, 1, 1), 0.01))
        self.alpha = nn.Parameter(torch.ones(()))
        self.n_iter = n_iter
        self.to(device)

    def forward(self, x):
        return self.alpha * x + self.Wd(self.encode(x))

    def encode(self, x):
        """The sparse code after ``n_iter`` ISTA steps (poisson2sparse.py:43)."""
        z = torch.zeros_like(self.We(x))
        for k in range(self.n_iter):
            z = z + self.Wg(x - self.Wd(z))
            z = torch.sign(z) * (z.abs() - self.theta[k].abs()).clamp(min=0.0)
        return z


class Poisson2Sparse(Denoiser):
    """Single-image self-supervised Poisson denoiser (poisson2sparse.py:53):
    ``train_steps`` Adam steps (``lr``) on a copy of a ConvLista, each on a
    fresh pair of neighbour sub-images, then the fitted network's output.

    :param generator: CPU ``torch.Generator`` of the network's initialization.
    :param device: the CUDA device by default.
    """

    def __init__(self, n_iter: int = 10, n_filters: int = 32, train_steps: int = 200,
                 lr: float = 1e-3, sparsity: float = 1e-4, generator=None, device=None):
        super().__init__()
        self.net = ConvLista(n_filters=n_filters, n_iter=n_iter, generator=generator,
                             device=device)
        self.train_steps = train_steps
        self.lr = lr
        self.sparsity = sparsity

    @staticmethod
    def _neighbors(y, choice, offset):
        """The sub-images of pixel ``choice`` and pixel ``choice + offset``
        (mod 4) of each 2x2 cell (poisson2sparse.py:65); ``choice`` and
        ``offset`` are ``(B, 1, H // 2, W // 2)``."""
        B, C, H, W = y.shape
        H2, W2 = H // 2, W // 2
        cells = y[:, :, :H2 * 2, :W2 * 2].reshape(B, C, H2, 2, W2, 2)
        cells = cells.movedim(3, -2).reshape(B, C, H2, W2, 4)
        pick = lambda i: cells.gather(-1, (i % 4)[..., None].expand(B, C, H2, W2, 1))[..., 0]
        return pick(choice), pick(choice + offset)

    def forward(self, y, sigma=None, generator=None, draws=None, **kwargs):
        """The denoised ``y``. Step ``i`` draws ``choice`` uniform on {0..3}
        and ``offset`` on {1, 2, 3} for each cell, from ``generator`` (one
        seeded 0 where None) or, in that order, from ``draws``
        (poisson2sparse.py:68-69, drawn from ``fold_in(key, i)`` there)."""
        rng = Draws.of(generator, seed=0, draws=draws, device=y.device)
        B, _, H, W = y.shape
        shape = (B, 1, H // 2, W // 2)
        net = copy.deepcopy(self.net)
        opt = torch.optim.Adam(net.parameters(), lr=self.lr)
        with torch.enable_grad():
            for _ in range(self.train_steps):
                choice = rng.randint(0, 4, shape)
                offset = rng.randint(1, 4, shape)
                g1, g2 = self._neighbors(y, choice, offset)
                loss = ((net(g1) - g2) ** 2).mean() + self.sparsity * net.encode(y).abs().mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        with torch.no_grad():
            return net(y)

"""Patch priors (port of deepinv_tpu/optim/patch_prior.py): ``PatchPrior``
over any patch potential, and ``PatchNR``, a normalizing flow of affine
coupling layers (RealNVP) over flattened patches."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.rng import Draws
from ..device import resolve_device
from .epll import patch_extractor
from .prior import Prior

__all__ = ["PatchPrior", "PatchNR"]


class PatchPrior(Prior):
    """``g(x) = sum over patches of phi(patch)`` (patch_prior.py:24), the
    first ``n_patches`` patches where positive."""

    def __init__(self, negative_patch_log_likelihood, patch_size: int = 6, n_patches: int = -1,
                 pad: bool = False):
        super().__init__()
        self.nll = negative_patch_log_likelihood
        self.patch_size = patch_size
        self.n_patches = n_patches

    def fn(self, x, *args, **kwargs):
        patches, _ = patch_extractor(x, self.patch_size)
        B, N, d = patches.shape
        if 0 < self.n_patches < N:
            patches = patches[:, : self.n_patches]
        return self.nll(patches.reshape(-1, d)).reshape(B, -1).sum(1)


def _linear(n_in: int, n_out: int, generator):
    """``nn.Linear`` with the JAX ``Linear``'s initialization (layers.py:172):
    weights uniform in ``+-1 / sqrt(n_in)``, zero bias."""
    lin = nn.Linear(n_in, n_out)
    bound = 1 / math.sqrt(n_in)
    with torch.no_grad():
        lin.weight.copy_((torch.rand((n_out, n_in), generator=generator) * 2 - 1) * bound)
        lin.bias.zero_()
    return lin


class _Coupling(nn.Module):
    """An affine coupling layer with a two-layer MLP conditioner
    (patch_prior.py:42): ``x = [a, b]``; ``flip=False`` scales and shifts
    ``b`` given ``a``, ``flip=True`` ``a`` given ``b``; the log-scale through
    tanh; the last layer starts at zero (the identity flow)."""

    def __init__(self, dim: int, hidden: int, flip: bool, generator=None):
        super().__init__()
        self.d1 = dim // 2
        self.d2 = dim - self.d1
        self.flip = flip
        cond_dim, out_dim = (self.d2, self.d1) if flip else (self.d1, self.d2)
        self.out_dim = out_dim
        self.l1 = _linear(cond_dim, hidden, generator)
        self.l2 = _linear(hidden, hidden, generator)
        self.l3 = _linear(hidden, 2 * out_dim, generator)
        with torch.no_grad():
            self.l3.weight.zero_()

    def _net(self, cond):
        h = F.gelu(self.l1(cond), approximate="tanh")
        h = F.gelu(self.l2(h), approximate="tanh")
        out = self.l3(h)
        return torch.tanh(out[..., : self.out_dim]), out[..., self.out_dim:]

    def forward(self, x):
        a, b = x[..., : self.d1], x[..., self.d1:]
        if self.flip:
            s, t = self._net(b)
            a = a * torch.exp(s) + t
        else:
            s, t = self._net(a)
            b = b * torch.exp(s) + t
        return torch.cat([a, b], dim=-1), s.sum(-1)

    def inverse(self, z):
        a, b = z[..., : self.d1], z[..., self.d1:]
        if self.flip:
            s, t = self._net(b)
            a = (a - t) * torch.exp(-s)
        else:
            s, t = self._net(a)
            b = (b - t) * torch.exp(-s)
        return torch.cat([a, b], dim=-1)


class PatchNR(Prior):
    """Normalizing-flow patch prior (patch_prior.py:94): ``g(x) = sum over
    patches of -log p_flow(patch)``, ``p_flow`` a RealNVP of ``n_layers``
    coupling layers (alternating halves) over flattened patches.

    :param generator: CPU ``torch.Generator`` of the initialization (seeded
        from ``seed`` where None).
    :param device: the CUDA device by default.
    """

    def __init__(self, patch_size: int = 6, channels: int = 1, n_layers: int = 5,
                 hidden: int = 128, generator=None, seed: int = 0, device=None):
        device = resolve_device(device)
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.patch_size = patch_size
        self.channels = channels
        self.dim = channels * patch_size ** 2
        self.layers = nn.ModuleList([_Coupling(self.dim, hidden, flip=(i % 2 == 1), generator=g)
                                     for i in range(n_layers)])
        self.to(device)

    def flow_forward(self, x):
        """``x -> (z, log |det J|)`` (patch_prior.py:112)."""
        logdet = x.new_zeros(x.shape[:-1])
        z = x
        for layer in self.layers:
            z, ld = layer(z)
            logdet = logdet + ld
        return z, logdet

    def flow_inverse(self, z):
        """The flow's inverse (patch_prior.py:121)."""
        x = z
        for layer in reversed(self.layers):
            x = layer.inverse(x)
        return x

    def nll(self, patches):
        """``-log p_flow`` of ``(N, d)`` patches (patch_prior.py:127)."""
        z, logdet = self.flow_forward(patches)
        log_pz = -0.5 * (z ** 2).sum(-1) - 0.5 * self.dim * math.log(2 * math.pi)
        return -(log_pz + logdet)

    def fn(self, x, *args, **kwargs):
        patches, _ = patch_extractor(x, self.patch_size)
        B, N, d = patches.shape
        return self.nll(patches.reshape(-1, d)).reshape(B, N).sum(1)

    def fit(self, patches, n_steps: int = 500, lr: float = 1e-3, batch_size: int = 256,
            generator=None, verbose: bool = False):
        """Maximum-likelihood training on ``(N, d)`` clean patches by Adam
        (patch_prior.py:137), each step on a batch drawn with replacement from
        ``generator`` (seeded 7 where None). Trains in place; returns the
        model."""
        patches = torch.as_tensor(patches, device=self.layers[0].l1.weight.device)
        n = patches.shape[0]
        dr = Draws.of(generator, 7, device=patches.device)
        opt = torch.optim.Adam(self.parameters(), lr=lr)
        for i in range(n_steps):
            batch = patches[dr.randint(0, n, (min(batch_size, n),))]
            opt.zero_grad(set_to_none=True)
            loss = self.nll(batch).mean()
            loss.backward()
            opt.step()
            if verbose and i % 100 == 0:
                print(f"PatchNR step {i}: nll {float(loss):.3f}")
        return self

"""Priors ``g(x)`` (port of deepinv_tpu/optim/prior.py): the base, ``Zero``
and the Plug-and-Play prior. RED, score, TV and the sparsity priors wait for
their slices (ROADMAP queue 1)."""

from __future__ import annotations

import torch

from .potential import Potential

__all__ = ["Prior", "Zero", "PnP"]


class Prior(Potential):
    r"""Base prior (deepinv_tpu/optim/prior.py:35). ``explicit_prior`` marks
    priors with a cost function; ``Prior(g=callable)`` wraps one."""

    explicit_prior = True

    def __init__(self, g=None):
        super().__init__(fn=g)


class Zero(Prior):
    r"""``g(x) = 0`` (prior.py:55)."""

    def fn(self, x, *args, **kwargs):
        return x.new_zeros(x.shape[0])

    def grad(self, x, *args, **kwargs):
        return torch.zeros_like(x)

    def prox(self, x, *args, gamma=1.0, **kwargs):
        return x


class PnP(Prior):
    r"""Plug-and-Play prior: the prox is a denoiser (prior.py:68)."""

    explicit_prior = False

    def __init__(self, denoiser):
        super().__init__()
        self.denoiser = denoiser

    def prox(self, x, sigma_denoiser, *args, gamma=None, **kwargs):
        return self.denoiser(x, sigma_denoiser)

"""Sampling utilities (port of deepinv_tpu/sampling/utils.py): ``Welford``
(:11), ``SDEOutput`` (:37) and ``projbox`` (:47); and, new in the port,
:func:`frozen`, which keeps a denoiser's weights out of a guidance gradient.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

__all__ = ["Welford", "SDEOutput", "projbox", "frozen"]


class Welford:
    """Online mean and variance (deepinv_tpu/sampling/utils.py:11)."""

    def __init__(self, x0):
        self.k = 1
        self.M = x0
        self.S = torch.zeros_like(x0)

    def update(self, x):
        self.k += 1
        delta = x - self.M
        self.M = self.M + delta / self.k
        self.S = self.S + delta * (x - self.M)
        return self

    def mean(self):
        return self.M

    def var(self):
        return self.S / max(self.k - 1, 1)


class SDEOutput(dict):
    """Output of an SDE solver (utils.py:37): ``sample``, ``trajectory``,
    ``nfe`` as keys and attributes."""

    def __init__(self, sample, trajectory=None, nfe: int = 0):
        super().__init__(sample=sample, trajectory=trajectory, nfe=nfe)
        self.sample = sample
        self.trajectory = trajectory
        self.nfe = nfe


def projbox(x, lo, hi):
    """``x`` clipped to ``[lo, hi]`` (utils.py:47)."""
    return torch.clamp(x, lo, hi)


@contextlib.contextmanager
def frozen(model):
    """Inside the block, ``model``'s parameters ask for no gradient; their
    flags are restored on exit (new in the port).

    The JAX samplers differentiate with respect to ``x_t`` alone
    (``jax.value_and_grad(loss)(x)``, diffusion.py:330). Here autograd
    would also build the weights' part of the graph, and a custom
    ``autograd.Function`` such as K1's asks for the gradients its inputs
    require: with the weights frozen, K1's backward computes ``dh`` only and
    ``autocast`` reuses its cached bf16 weights. A model that is not an
    ``nn.Module`` is called as it is.
    """
    params = ([p for p in model.parameters() if p.requires_grad]
              if isinstance(model, nn.Module) else [])
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)

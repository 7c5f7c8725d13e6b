"""Denoiser / Reconstructor bases and sigma handling (port of
deepinv_tpu/models/base.py)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Denoiser", "Reconstructor", "handle_sigma"]


def handle_sigma(sigma, x: torch.Tensor) -> torch.Tensor:
    """Noise level as a ``(B, 1, *spatial)`` map in ``x``'s dtype
    (deepinv_tpu/models/base.py:14): scalar, ``(B,)``, ``(B, 1)``,
    ``(B, 1, 1, ...)``, ``(1,)`` or a full map."""
    B, spatial = x.shape[0], tuple(x.shape[2:])
    full = (B, 1) + spatial
    if isinstance(sigma, (int, float)) or (isinstance(sigma, torch.Tensor) and sigma.numel() == 1
                                           and sigma.device.type == "cpu"
                                           and not sigma.requires_grad):
        # a host number is filled in on x's device: a host-to-device copy
        # would wait for the device to finish its queue
        return x.new_full((), float(sigma)).expand(full)
    s = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    if s.dim() == 0 or tuple(s.shape) == (1,):
        return s.reshape(()).expand(full)
    if tuple(s.shape) in ((B,), (B, 1), (B,) + (1,) * len(spatial)):
        return s.reshape((B, 1) + (1,) * len(spatial)).expand(full)
    if tuple(s.shape) == full:
        return s
    raise ValueError(f"cannot broadcast sigma of shape {tuple(s.shape)} to {tuple(x.shape)}")


class Denoiser(nn.Module):
    """Base denoiser: ``xhat = denoiser(x, sigma)`` (base.py:32)."""

    def forward(self, x, sigma=None, **kwargs):
        raise NotImplementedError


class Reconstructor(nn.Module):
    """Base reconstructor: ``xhat = model(y, physics)`` (base.py:54)."""

    def forward(self, y, physics, **kwargs):
        raise NotImplementedError

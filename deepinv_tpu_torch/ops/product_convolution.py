"""Product convolution, the space-varying blur ``y = sum_k h_k * (w_k . x)``
(port of deepinv_tpu/ops/product_convolution.py).

The K branches are summed in a loop over k (the JAX package maps them with
``jax.vmap``); the adjoint is the autograd transpose of the forward.
"""

from __future__ import annotations

import torch

from ..core.linalg import linear_transpose
from .conv import conv2d, conv2d_fft

__all__ = ["product_convolution2d", "product_convolution2d_adjoint", "multiplier"]


def multiplier(x, w):
    """Hadamard product with broadcasting (product_convolution.py:19)."""
    return x * w


def product_convolution2d(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                          padding: str = "valid", use_fft: bool = False) -> torch.Tensor:
    """``y = sum_k h_k * (w_k . x)`` (product_convolution.py:24).

    :param x: ``(B, C, H, W)``.
    :param w: multipliers ``(b, c, K, H, W)``, b in {1, B}, c in {1, C}.
    :param h: filters ``(b, c, K, hh, ww)``.
    :param use_fft: convolve by :func:`~deepinv_tpu_torch.ops.conv2d_fft`.
    """
    conv = conv2d_fft if use_fft else conv2d
    out = None
    for k in range(w.shape[2]):
        term = conv(x * w[:, :, k], h[:, :, k], padding=padding)
        out = term if out is None else out + term
    return out


def product_convolution2d_adjoint(y: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                                  padding: str = "valid", use_fft: bool = False) -> torch.Tensor:
    """Exact adjoint of :func:`product_convolution2d`
    (product_convolution.py:41)."""
    B, C = y.shape[:2]
    return linear_transpose(
        lambda x: product_convolution2d(x, w, h, padding=padding, use_fft=use_fft), y,
        (B, C) + tuple(w.shape[-2:]), create_graph=w.requires_grad or h.requires_grad)

"""Small functional helpers (port of deepinv_tpu/utils/functional.py).

Impulses are built on the host as PyTorch's filters are
(:mod:`deepinv_tpu_torch.ops.conv`); the ``*_like`` helpers follow their
argument's device and dtype, a :class:`TensorList` member by member. Random
draws come from a ``torch.Generator`` on the argument's device: the JAX
package's ``key=`` has no bitwise counterpart, so a seed gives the port's own
numbers.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tensorlist import TensorList
from ..device import resolve_device

__all__ = ["complex_abs", "dirac", "dirac_like", "dirac_comb", "dirac_comb_like", "ones_like",
           "zeros_like", "rand_like", "randn_like", "get_timestamp", "get_device",
           "devices_equal", "normalize_signal", "resize_pad_square_tensor"]


def complex_abs(x, dim: int = 1, keepdims: bool = True):
    """The magnitude of a complex tensor, or of a real one whose axis ``dim``
    holds (real, imaginary) (functional.py:37)."""
    if x.is_complex():
        return x.abs()
    assert x.shape[dim] == 2, "expected 2 channels (real, imag)"
    return x.pow(2).sum(dim, keepdim=keepdims).sqrt()


def dirac(shape) -> torch.Tensor:
    """A float32 impulse at the centre of the last two axes (functional.py:46).

    :Examples:

        >>> from deepinv_tpu_torch.utils import dirac
        >>> d = dirac((1, 1, 5, 5))
        >>> float(d.sum()), float(d[0, 0, 2, 2])
        (1.0, 1.0)
    """
    out = np.zeros(shape, np.float32)
    out[..., shape[-2] // 2, shape[-1] // 2] = 1.0
    return torch.from_numpy(out)


def dirac_like(x):
    """:func:`dirac` of ``x``'s shape, dtype and device (functional.py:61)."""
    if isinstance(x, TensorList):
        return TensorList([dirac_like(v) for v in x])
    return dirac(tuple(x.shape)).to(device=x.device, dtype=x.dtype)


def dirac_comb(shape, period: int = 2) -> torch.Tensor:
    """A float32 impulse train of ``period`` on the last two axes
    (functional.py:67)."""
    out = np.zeros(shape, np.float32)
    out[..., ::period, ::period] = 1.0
    return torch.from_numpy(out)


def dirac_comb_like(x, period: int = 2):
    if isinstance(x, TensorList):
        return TensorList([dirac_comb_like(v, period) for v in x])
    return dirac_comb(tuple(x.shape), period).to(device=x.device, dtype=x.dtype)


def _map(fn, x):
    return TensorList([fn(v) for v in x]) if isinstance(x, TensorList) else fn(x)


def ones_like(x):
    return _map(torch.ones_like, x)


def zeros_like(x):
    return _map(torch.zeros_like, x)


def _draw(fn, x, generator, seed):
    """``fn`` of each member's shape, dtype and device, from ``generator`` or
    one seeded with ``seed`` on the first member's device: one draw a member,
    in order (functional.py:88-105)."""
    leaves = list(x) if isinstance(x, TensorList) else [x]
    if generator is None:
        generator = torch.Generator(device=leaves[0].device).manual_seed(int(seed))
    return _map(lambda v: fn(v.shape, generator=generator, dtype=v.dtype, device=v.device), x)


def rand_like(x, generator=None, seed: int = 0):
    """Uniform [0, 1) draws shaped like ``x`` (functional.py:88)."""
    return _draw(torch.rand, x, generator, seed)


def randn_like(x, generator=None, seed: int = 0):
    """Standard normal draws shaped like ``x`` (functional.py:98)."""
    return _draw(torch.randn, x, generator, seed)


def get_timestamp() -> str:
    """A timestamp that is safe in a file name (functional.py:108)."""
    return datetime.datetime.now().strftime("%y-%m-%d-%H:%M:%S")


def get_device() -> torch.device:
    """The device the port's entry points use by default: the CUDA device;
    raises without one (functional.py:113,
    :func:`~deepinv_tpu_torch.device.resolve_device`)."""
    return resolve_device(None)


def devices_equal(a, b) -> bool:
    return str(a) == str(b)


def normalize_signal(x, mode: str = "min_max"):
    """Each sample rescaled to [0, 1] by its minimum and maximum, or clipped
    to it with ``mode="clip"`` (functional.py:123)."""
    if mode == "clip":
        return x.clamp(0.0, 1.0)
    axes = tuple(range(1, x.dim()))
    lo = x.amin(dim=axes, keepdim=True)
    hi = x.amax(dim=axes, keepdim=True)
    return (x - lo) / (hi - lo).clamp_min(1e-12)


def resize_pad_square_tensor(x, size: int):
    """``(B, C, H, W)`` resized bilinearly to fit a ``size`` square, keeping its
    aspect ratio, then zero-padded to it (functional.py:136). A shrink is
    antialiased, as ``jax.image.resize`` is."""
    B, C, H, W = x.shape
    s = size / max(H, W)
    nh, nw = int(round(H * s)), int(round(W * s))
    out = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    ph, pw = size - nh, size - nw
    return F.pad(out, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))

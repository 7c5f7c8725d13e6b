"""Single-pixel camera (port of deepinv_tpu/physics/singlepixel.py).

``A = S H``: ``H`` the orthonormal 2-D Walsh-Hadamard transform and ``S`` a
binary selection of ``m`` patterns in one of four orderings (the masks are
numpy on the host, as in the JAX package). Up to 4096 a side the transform
is one dense product with ``H_n`` an axis (singlepixel.py:34-64), as the
JAX package does, else a butterfly. The product runs in exact f32 (no TF32,
no autocast, :func:`~deepinv_tpu_torch.core.exact_f32`): the closed-form
``prox_l2`` and ``A_dagger`` of :class:`DecomposablePhysics` rely on
``V(V_adjoint(x)) = x``, which a bf16 or TF32 product breaks at 1e-3-1e-2.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from ..core.linalg import exact_f32
from ..device import resolve_device
from .base import DecomposablePhysics

__all__ = ["SinglePixelCamera", "hadamard_1d", "hadamard_2d", "sequency_order"]

# the largest side transformed by one dense product (singlepixel.py:34)
_DENSE_MAX = 4096


def _hadamard_matrix(n: int) -> np.ndarray:
    """The dense Sylvester-order Hadamard matrix (singlepixel.py:23)."""
    H = np.array([[1.0]], np.float32)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


@functools.lru_cache(maxsize=8)
def _hadamard(n: int, device: torch.device) -> torch.Tensor:
    """``H_n`` on ``device``, made once a size and device."""
    return torch.from_numpy(_hadamard_matrix(n)).to(device)


def hadamard_1d(u: torch.Tensor, axis: int = -1, normalize: bool = True) -> torch.Tensor:
    """Walsh-Hadamard transform in natural order along ``axis``
    (singlepixel.py:40): a dense product with ``H_n`` for n <= 4096, the
    log2(n) butterfly above; f32 whatever the caller's precision."""
    if u.is_complex():
        return torch.complex(hadamard_1d(u.real, axis, normalize),
                             hadamard_1d(u.imag, axis, normalize))
    u = u.movedim(axis, -1)
    n = u.shape[-1]
    k = int(math.log2(n))
    if 2 ** k != n:
        raise ValueError("the Walsh-Hadamard transform needs a power-of-two length")
    with exact_f32(u.device.type):
        v = u.float()
        if n <= _DENSE_MAX:
            v = v @ _hadamard(n, u.device)    # H is symmetric
        else:
            for _ in range(k):
                v = v.reshape(v.shape[:-1] + (v.shape[-1] // 2, 2))
                v = torch.cat([v[..., 0] + v[..., 1], v[..., 0] - v[..., 1]], dim=-1)
        if normalize:
            v = v / math.sqrt(n)
    return v.movedim(-1, axis)


def hadamard_2d(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """The 2-D transform over the last two axes (singlepixel.py:69)."""
    return hadamard_1d(hadamard_1d(x, axis=-1, normalize=normalize), axis=-2,
                       normalize=normalize)


def _gray_code(nbits: int) -> np.ndarray:
    g = np.arange(2 ** nbits) ^ (np.arange(2 ** nbits) >> 1)
    return ((g[:, None] >> np.arange(nbits - 1, -1, -1)) & 1).astype(np.int64)


def sequency_order(n: int) -> np.ndarray:
    """Natural indices in sequency order (singlepixel.py:79)."""
    nbits = int(math.log2(n))
    G = _gray_code(nbits)[:, ::-1]
    return G.dot(2 ** np.arange(nbits - 1, -1, -1)).astype(np.int64)


def _hadamard_ishift_2d(mask_np: np.ndarray) -> np.ndarray:
    """A sequency-ordered 2-D selection mapped back to natural order
    (singlepixel.py:86)."""
    H, W = mask_np.shape[-2:]
    out = np.zeros_like(mask_np)
    out[..., sequency_order(H), :] = mask_np
    out2 = np.zeros_like(out)
    out2[..., :, sequency_order(W)] = out
    return out2


def _select(img_size, idx) -> np.ndarray:
    C, H, W = img_size
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    i, j = i.flatten(order="F"), j.flatten(order="F")
    mask = np.zeros((1, C, H, W), np.float32)
    mask[:, :, i[idx], j[idx]] = 1.0
    return mask


def _sequency_mask(img_size, m) -> np.ndarray:
    """The first ``m`` patterns in sequency order (singlepixel.py:99)."""
    return _select(img_size, sequency_order(img_size[1] * img_size[2])[:m])


def _cake_cutting_order(n: int) -> np.ndarray:
    p = int(np.sqrt(n))
    seq = []
    for i in range(1, p + 1):
        step = -i * (-1) ** (i % 2)
        if i % 2 == 1:
            seq += list(range(i, i * p + 1, step))
        else:
            seq += list(range(i * p, i - 1, step))
    return np.argsort(seq)


def _cake_cutting_mask(img_size, m) -> np.ndarray:
    """The cake-cutting ordering (singlepixel.py:123)."""
    _, H, W = img_size
    if H != W:
        warnings.warn("cake cutting mask assumes square images")
    n = H * W
    return _select(img_size, sequency_order(n)[_cake_cutting_order(n)][:m])


def _zig_zag_mask(img_size, m) -> np.ndarray:
    """The zig-zag ordering (singlepixel.py:136)."""
    C, H, W = img_size
    I, J = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    order = np.argsort(((I + J).flatten() * H * W - I.flatten()), kind="stable")
    flat = np.empty(H * W, np.int64)
    flat[order] = np.arange(H * W)
    mask = np.broadcast_to((flat.reshape(H, W) < m).astype(np.float32), (1, C, H, W)).copy()
    return _hadamard_ishift_2d(mask)


def _xy_mask(img_size, m) -> np.ndarray:
    """The xy ordering (singlepixel.py:148)."""
    C, H, W = img_size
    X, Y = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    index_matrix = X * Y + (X ** 2 + Y ** 2) / 4
    index_matrix = index_matrix / index_matrix.max()
    indx = np.argsort(index_matrix.flatten(), kind="stable")
    out = np.empty(H * W, np.int64)
    out[indx] = np.arange(1, H * W + 1)
    mask = np.broadcast_to((out.reshape(H, W) <= m).astype(np.float32), (1, C, H, W)).copy()
    return _hadamard_ishift_2d(mask)


_ORDERINGS = {"sequency": _sequency_mask, "cake_cutting": _cake_cutting_mask,
              "zig_zag": _zig_zag_mask, "xy": _xy_mask}


class SinglePixelCamera(DecomposablePhysics):
    r"""``y = S H x`` (singlepixel.py:163): ``m`` Hadamard patterns of a
    ``(C, H, W)`` image (H and W powers of two) in ``ordering``
    (``"sequency"``, ``"cake_cutting"``, ``"zig_zag"``, ``"xy"``).
    ``A_dagger`` and ``prox_l2`` are closed forms.

    :param device: where the mask lives; the CUDA device by default.
    """

    def __init__(self, m: int, img_size, ordering: str = "sequency", fast: bool = True,
                 device=None, **kwargs):
        device = resolve_device(device)
        if ordering not in _ORDERINGS:
            raise ValueError(f"unknown ordering {ordering!r}")
        self.img_size = tuple(img_size)
        self.m = int(m)
        self.ordering = ordering
        mask = torch.from_numpy(_ORDERINGS[ordering](self.img_size, self.m))
        super().__init__(mask=mask, **kwargs)
        self.to(device)

    def V_adjoint(self, x):
        return hadamard_2d(x)

    def V(self, y):
        return hadamard_2d(y)   # the orthonormal transform is its own inverse

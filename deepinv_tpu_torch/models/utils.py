"""Model helpers (port of deepinv_tpu/models/utils.py), and the weight
stacking of the port's kernel call sites (:func:`stacked_weights`, new in the
port)."""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

__all__ = ["test_pad", "test_onesplit", "stacked_weights", "tensors_key", "same_tensors",
           "pad_hw", "resize_bilinear"]


def test_pad(model, x, modulo: int = 16):
    """Edge-pad every spatial dim of ``x`` (2D or 3D) to a multiple of
    ``modulo``, run ``model``, crop back (deepinv_tpu/models/utils.py:10)."""
    spatial = tuple(x.shape[2:])
    pads = []
    for s in reversed(spatial):
        pads += [0, (-s) % modulo]
    xp = F.pad(x, pads, mode="replicate")
    return model(xp)[(Ellipsis,) + tuple(slice(0, s) for s in spatial)]


def _pad_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Source indices of ``numpy.pad``'s ``wrap`` / ``reflect`` / ``edge`` modes
    along an axis of ``n``, for any pad widths (torch's circular and reflect
    pads refuse widths past the axis)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "wrap":
        return i % n
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = i % period
        return torch.where(i >= n, period - i, i)
    raise ValueError(f"unknown pad mode {mode!r}")


def pad_hw(x, top: int, bottom: int, left: int, right: int, mode: str):
    """Pad the last two axes of ``x`` as ``jnp.pad`` does in ``mode``
    (``"wrap"``, ``"reflect"`` or ``"edge"``), for any widths."""
    H, W = x.shape[-2:]
    if top or bottom:
        x = x.index_select(-2, _pad_index(H, top, bottom, mode, x.device))
    if left or right:
        x = x.index_select(-1, _pad_index(W, left, right, mode, x.device))
    return x


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s ``(n_in, n_out)`` weights along one axis
    (``compute_weight_mat`` with the triangle kernel, antialiased): half-pixel
    centres, the kernel widened by the shrink factor, each column normalised."""
    scale = torch.tensor(n_out, dtype=torch.float32) / torch.tensor(n_in, dtype=torch.float32)
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    d = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - d, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear(x, size) -> torch.Tensor:
    """``jax.image.resize(x, (..., H, W), "bilinear")`` of the last two axes:
    antialiased when shrinking, as the JAX package's resizes are (torch's
    ``interpolate`` weighs the edges otherwise)."""
    H, W = x.shape[-2:]
    if (H, W) != tuple(size):
        x = torch.einsum("...hw,hH,wW->...HW", x, _resize_matrix(H, size[0], x.device).to(x.dtype),
                         _resize_matrix(W, size[1], x.device).to(x.dtype))
    return x


def test_onesplit(model, x, refield: int = 64, sf: int = 1):
    """Run ``model`` on four overlapping quadrants of ``x`` and reassemble the
    output, ``sf`` times larger (deepinv_tpu/models/utils.py:20). The JAX
    function writes each right-hand quadrant's full height into half the
    output and raises for every input (ROADMAP queue 3); this one crops it,
    as the upstream ``test_onesplit`` does."""
    H, W = x.shape[-2:]
    th = (H // 2 // refield + 1) * refield
    tw = (W // 2 // refield + 1) * refield
    top, bottom = slice(0, th), slice(H - th, H)
    left, right = slice(0, tw), slice(W - tw, W)
    outs = [model(x[..., top, left]), model(x[..., top, right]),
            model(x[..., bottom, left]), model(x[..., bottom, right])]
    h, w = H // 2, W // 2
    dh, dw = (h - H + th) * sf, (w - W + tw) * sf
    out = outs[0].new_zeros(tuple(outs[0].shape[:-2]) + (H * sf, W * sf))
    out[..., :h * sf, :w * sf] = outs[0][..., :h * sf, :w * sf]
    out[..., :h * sf, w * sf:] = outs[1][..., :h * sf, dw:]
    out[..., h * sf:, :w * sf] = outs[2][..., dh:, :w * sf]
    out[..., h * sf:, w * sf:] = outs[3][..., dh:, dw:]
    return out


def tensors_key(tensors) -> tuple:
    """What identifies ``tensors`` for a cache of values made from them: a weak
    reference to each (a tensor made later at a freed one's address, such as
    a fresh bf16 cast, is another tensor) and its storage, version counter,
    dtype and device."""
    return tuple((weakref.ref(t), t.data_ptr(), t._version, t.dtype, t.device) for t in tensors)


def same_tensors(key: tuple, tensors) -> bool:
    """Whether ``tensors`` are the ones :func:`tensors_key` saw, unchanged."""
    return len(key) == len(tensors) and all(
        k[0]() is t and k[1:] == (t.data_ptr(), t._version, t.dtype, t.device)
        for k, t in zip(key, tensors))


def stacked_weights(owner, groups, pack, name: str = "chain"):
    """Stack each group of per-layer tensors into one ``(L, ...)`` tensor and
    pack the stacks for a kernel, once per weight version.

    The result is kept on ``owner`` (in ``owner._packed[name]``, one entry per
    kernel call site) until one of the tensors changes (:func:`tensors_key`):
    it is another tensor, or its storage, version counter, dtype or device
    changed. Under autograd the stacks are
    rebuilt on every call, so gradients reach each layer, and nothing is
    packed.

    :param groups: sequences of tensors, one sequence per stack; a single
        tensor is passed through as it is.
    :param pack: ``pack(*stacks)``, called for CUDA tensors only.
    :param name: the call site's key in the cache.
    :return: ``(*stacks, packed)``; ``packed`` is None off the GPU and under
        autograd.
    """
    def stack(g):
        return g if isinstance(g, torch.Tensor) else torch.stack(list(g))

    flat = [t for g in groups for t in ([g] if isinstance(g, torch.Tensor) else g)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return (*(stack(g) for g in groups), None)
    cache = owner.__dict__.setdefault("_packed", {})
    cached = cache.get(name)
    if cached is None or not same_tensors(cached[0], flat):
        stacks = tuple(stack(g).detach() for g in groups)
        cached = (tensors_key(flat), (*stacks, pack(*stacks) if stacks[0].is_cuda else None))
        cache[name] = cached
    return cached[1]

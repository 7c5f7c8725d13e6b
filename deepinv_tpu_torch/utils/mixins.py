"""Mixins: time flattening and 2D tiles (port of deepinv_tpu/utils/mixins.py).

:class:`TimeMixin` (mixins.py:22) moves the time axis of ``(B, C, T, H, W)``
data in and out of the batch or the channels; the tiling helpers (:79-247)
cut ``(B, C, H, W)`` images into overlapping patches ``(B, C, n_h, n_w, ph,
pw)`` and put them back, and :class:`TiledMixin2d` (:249) gives a class
their geometry.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["TimeMixin", "TiledMixin2d", "tiled_apply", "image_to_patches", "patches_to_image",
           "patchify"]


class TimeMixin:
    """Helpers of ``(B, C, T, H, W)`` data (mixins.py:22)."""

    @staticmethod
    def flatten(x):
        """``(B, C, T, H, W)`` -> ``(B*T, C, H, W)``."""
        B, C, T, H, W = x.shape
        return x.movedim(2, 1).reshape(B * T, C, H, W)

    @staticmethod
    def unflatten(x, batch_size: int = 1):
        """``(B*T, C, H, W)`` -> ``(B, C, T, H, W)``."""
        BT, C, H, W = x.shape
        return x.reshape(batch_size, BT // batch_size, C, H, W).movedim(1, 2)

    @staticmethod
    def flatten_C(x):
        """``(B, C, T, H, W)`` -> ``(B, C*T, H, W)``."""
        B, C, T, H, W = x.shape
        return x.reshape(B, C * T, H, W)

    @staticmethod
    def wrap_flatten_C(f):
        """``f`` applied with time folded into the channels (mixins.py:44)."""

        def wrapped(x, *args, **kwargs):
            B, C, T, H, W = x.shape
            return f(TimeMixin.flatten_C(x), *args, **kwargs).reshape(-1, C, T, H, W)

        return wrapped

    @staticmethod
    def average(x, mask=None, axis: int = 2):
        """The mean over the acquired frames (mixins.py:56): the sum over
        ``axis`` over the count of frames where ``mask`` (``x != 0`` by
        default) is nonzero; 0 where none is."""
        num = x.sum(axis)
        m = mask if mask is not None else (x != 0)
        cnt = m.to(x.dtype).sum(axis)
        return torch.where(cnt != 0, num / torch.where(cnt != 0, cnt, torch.ones_like(cnt)),
                           torch.zeros_like(num))

    @staticmethod
    def repeat(x, target, axis: int = 2):
        """``x`` repeated along a new ``axis`` as often as ``target`` has it."""
        return x.unsqueeze(axis).repeat_interleave(target.shape[axis], dim=axis)

    def to_static(self):
        """A time-collapsed version of this object (mixins.py:70); temporal
        physics override it."""
        raise NotImplementedError()


def _as_pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _resolve_tiling_params(patch_size, stride=None):
    """``(patch_size, stride)`` as pairs, the stride half the patch by
    default (mixins.py:83)."""
    p = _as_pair(patch_size)
    s = _as_pair(stride) if stride is not None else tuple(q // 2 for q in p)
    if s[0] > p[0] or s[1] > p[1]:
        raise ValueError(f"Stride {s} must be smaller or equal than patch_size {p}.")
    return p, s


def _compute_needed_pad(img_size, patch_size, stride):
    n_h = abs(img_size[0] - patch_size[0]) // stride[0] + 1
    n_w = abs(img_size[1] - patch_size[1]) // stride[1] + 1
    return ((patch_size[0] + n_h * stride[0] - img_size[0]) % stride[0],
            (patch_size[1] + n_w * stride[1] - img_size[1]) % stride[1])


def _compute_compatible_img_size(img_size, patch_size, stride):
    ph, pw = _compute_needed_pad(img_size, patch_size, stride)
    return img_size[0] + ph, img_size[1] + pw


def _compute_num_patches(img_size, patch_size, stride, pad_if_needed):
    size = (_compute_compatible_img_size(img_size, patch_size, stride) if pad_if_needed
            else img_size)
    return ((size[0] - patch_size[0]) // stride[0] + 1,
            (size[1] - patch_size[1]) // stride[1] + 1)


def image_to_patches(image, patch_size, stride=None, pad_if_needed=True, pad=(0, 0, 0, 0)):
    """``(B, C, H, W)`` cut into overlapping patches ``(B, C, n_h, n_w, ph,
    pw)`` (mixins.py:116). ``pad = (left, right, top, bottom)`` adds context
    around each patch (a larger patch); ``pad_if_needed`` pads the bottom and
    right so that the patches reach the edge."""
    patch_size, stride = _resolve_tiling_params(patch_size, stride)
    if image.dim() != 4:
        raise ValueError(f"Input image must have shape (B, C, H, W), got {tuple(image.shape)}.")
    extra = (pad,) * 4 if isinstance(pad, int) else tuple(pad)
    if len(extra) != 4:
        raise ValueError("Pad must be an int or a tuple of 4 ints (left, right, top, bottom).")
    full = extra
    if pad_if_needed:
        pad_h, pad_w = _compute_needed_pad(image.shape[-2:], patch_size, stride)
        full = (extra[0], extra[1] + pad_w, extra[2], extra[3] + pad_h)
    if any(p > 0 for p in full):
        image = F.pad(image, full)
    ph = patch_size[0] + extra[2] + extra[3]
    pw = patch_size[1] + extra[0] + extra[1]
    return image.unfold(2, ph, stride[0]).unfold(3, pw, stride[1])


def patches_to_image(patches, stride, img_size=None, reduce_overlap="mean"):
    """Patches ``(B, C, n_h, n_w, ph, pw)`` put back together, the overlaps
    summed or averaged (mixins.py:162); ``img_size`` crops the result."""
    if reduce_overlap not in ("sum", "mean"):
        raise ValueError(f"Invalid reduce_overlap option: {reduce_overlap}. Must be 'sum' or "
                         "'mean'.")
    sh, sw = _as_pair(stride)
    B, C, n_h, n_w, ph, pw = patches.shape
    H, W = ph + (n_h - 1) * sh, pw + (n_w - 1) * sw
    dev = patches.device
    rows = (torch.arange(n_h, device=dev)[:, None] * sh + torch.arange(ph, device=dev))
    cols = (torch.arange(n_w, device=dev)[:, None] * sw + torch.arange(pw, device=dev))
    lin = (rows[:, None, :, None] * W + cols[None, :, None, :]).reshape(-1)
    out = torch.zeros((B, C, H * W), dtype=patches.dtype, device=dev)
    out.index_add_(2, lin, patches.reshape(B, C, -1))
    if reduce_overlap == "mean":
        cnt = torch.zeros((H * W,), dtype=patches.dtype, device=dev).index_add_(
            0, lin, torch.ones_like(lin, dtype=patches.dtype))
        out = out / cnt.clamp_min(1.0)
    out = out.reshape(B, C, H, W)
    return out if img_size is None else out[:, :, :img_size[0], :img_size[1]]


def patchify(image, patch_size, stride=None, pad_if_needed=True):
    """:func:`image_to_patches` by another name (mixins.py:195)."""
    return image_to_patches(image, patch_size, stride, pad_if_needed=pad_if_needed)


def tiled_apply(fn, x, patch_size=256, overlap: int = 64):
    """``fn`` applied to overlapping patches, in one batched call, blended
    back with linear ramps over the overlaps (mixins.py:200). A patch larger
    than the image on one axis is cut to it."""
    B, C, H, W = x.shape
    ph, pw = _as_pair(patch_size)
    ph, pw = min(ph, H), min(pw, W)
    ov = overlap
    if H <= ph and W <= pw:
        return fn(x)

    def starts(size, p):
        s = list(range(0, max(size - p, 0) + 1, max(p - ov, 1)))
        if s[-1] + p < size:
            s.append(size - p)
        return s

    ys, xs = starts(H, ph), starts(W, pw)
    patches = torch.stack([x[:, :, i:i + ph, j:j + pw] for i in ys for j in xs], 0)
    N = patches.shape[0]
    outs = fn(patches.reshape(N * B, C, ph, pw)).reshape(N, B, C, ph, pw)

    def ramp(p):
        r = np.minimum(np.arange(1, p + 1), ov) / ov if ov > 0 else np.ones(p)
        return np.minimum(r, r[::-1])

    w = torch.as_tensor(np.outer(ramp(ph), ramp(pw)), dtype=x.dtype, device=x.device)
    acc = torch.zeros_like(x)
    cnt = torch.zeros((1, 1, H, W), dtype=x.dtype, device=x.device)
    k = 0
    for i in ys:
        for j in xs:
            acc[:, :, i:i + ph, j:j + pw] += outs[k] * w
            cnt[:, :, i:i + ph, j:j + pw] += w
            k += 1
    return acc / cnt.clamp_min(1e-8)


class TiledMixin2d:
    """The patch geometry of a class (mixins.py:249): ``image_to_patches``,
    ``patches_to_image`` (summing overlaps by default), the padding and
    count queries, and ``apply_tiled``, which blends a function's patches."""

    patch_size = (256, 256)
    stride = (128, 128)
    overlap: int = 64
    pad_if_needed: bool = True

    def __init__(self, patch_size=None, stride=None, pad_if_needed=True, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.patch_size, self.stride = _resolve_tiling_params(
            patch_size if patch_size is not None else self.patch_size,
            stride if stride is not None else (self.stride if patch_size is None else None))
        self.pad_if_needed = pad_if_needed

    def image_to_patches(self, image, pad=(0, 0, 0, 0)):
        return image_to_patches(image, self.patch_size, self.stride,
                                pad_if_needed=self.pad_if_needed, pad=pad)

    def patches_to_image(self, patches, img_size=None, reduce_overlap="sum"):
        return patches_to_image(patches, self.stride, img_size=img_size,
                                reduce_overlap=reduce_overlap)

    def get_needed_pad(self, img_size):
        return _compute_needed_pad(img_size, self.patch_size, self.stride)

    def get_compatible_img_size(self, img_size):
        return _compute_compatible_img_size(img_size, self.patch_size, self.stride)

    def get_num_patches(self, img_size):
        return _compute_num_patches(img_size, self.patch_size, self.stride, self.pad_if_needed)

    def apply_tiled(self, fn, x):
        return tiled_apply(fn, x, patch_size=self.patch_size, overlap=self.overlap)

"""Model helpers (port of deepinv_tpu/models/utils.py), and the weight
stacking of the port's kernel call sites (:func:`stacked_weights`, new in the
port)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["test_pad", "stacked_weights"]


def test_pad(model, x, modulo: int = 16):
    """Edge-pad the two spatial dims of ``x`` to multiples of ``modulo``, run
    ``model``, crop back (deepinv_tpu/models/utils.py:10)."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (0, (-W) % modulo, 0, (-H) % modulo), mode="replicate")
    return model(xp)[..., :H, :W]


def stacked_weights(owner, groups, pack, name: str = "chain"):
    """Stack each group of per-layer tensors into one ``(L, ...)`` tensor and
    pack the stacks for a kernel, once per weight version.

    The result is kept on ``owner`` (in ``owner._packed[name]``, one entry per
    kernel call site) until one of the tensors changes: its storage, its
    version counter, its dtype or its device. Under autograd the stacks are
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
    key = tuple((t.data_ptr(), t._version, t.dtype, t.device) for t in flat)
    cache = owner.__dict__.setdefault("_packed", {})
    cached = cache.get(name)
    if cached is None or cached[0] != key:
        stacks = tuple(stack(g).detach() for g in groups)
        cached = (key, (*stacks, pack(*stacks) if stacks[0].is_cuda else None))
        cache[name] = cached
    return cached[1]

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


def stacked_weights(owner, groups, pack):
    """Stack each group of per-layer tensors into one ``(L, ...)`` tensor and
    pack the stacks for a kernel, once per weight version.

    The result is kept on ``owner`` (as ``owner._packed``) until one of the
    tensors changes: its storage, its version counter, its dtype or its
    device. Under autograd the stacks are rebuilt on every call, so gradients
    reach each layer, and nothing is packed.

    :param groups: sequences of tensors, one sequence per stack.
    :param pack: ``pack(*stacks)``, called for CUDA tensors only.
    :return: ``(*stacks, packed)``; ``packed`` is None off the GPU and under
        autograd.
    """
    flat = [t for g in groups for t in g]
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return (*(torch.stack(list(g)) for g in groups), None)
    key = tuple((t.data_ptr(), t._version, t.dtype, t.device) for t in flat)
    cached = getattr(owner, "_packed", None)
    if cached is None or cached[0] != key:
        stacks = tuple(torch.stack(list(g)).detach() for g in groups)
        cached = (key, (*stacks, pack(*stacks) if stacks[0].is_cuda else None))
        owner._packed = cached
    return cached[1]

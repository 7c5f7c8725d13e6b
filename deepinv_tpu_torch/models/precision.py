"""Mixed-precision wrapper (port of deepinv_tpu/models/precision.py).

On the H100 as on the TPU, bf16 activations with f32 accumulation halve the
activation traffic and run the convolutions on the tensor cores; through a
PnP prox step the reconstruction stays within 0.1 dB of f32
(tests/test_models.py::test_autocast_bf16_parity).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from .base import Denoiser

__all__ = ["AutocastDenoiser", "autocast"]


class AutocastDenoiser(Denoiser):
    """Run ``denoiser`` on inputs cast to ``dtype``, cast the output back
    (deepinv_tpu/models/precision.py:23).

    :param denoiser: any ``denoiser(x, sigma)`` module. It is kept as it is:
        its float32 parameters are this module's parameters, so an optimizer
        over ``autocast(m).parameters()`` steps them.
    :param dtype: compute dtype (default bfloat16).
    :param cast_params: run the denoiser with its float32 parameters and
        buffers cast to ``dtype`` (default), as the JAX package's
        ``tree_map(astype)`` does. Where autograd needs a parameter's gradient
        the casts are made at each call and are differentiable, so the
        gradient reaches the float32 parameters through the cast (rounded to
        ``dtype`` on the way, as JAX's ``astype`` cotangent is). Otherwise a
        cached cast is used, made once per weight version (storage, version
        counter, dtype, device, as
        :func:`~deepinv_tpu_torch.models.utils.stacked_weights` keys its
        cache). ``False`` runs the denoiser with its parameters as they are.
    """

    def __init__(self, denoiser: nn.Module, dtype=torch.bfloat16, cast_params: bool = True):
        super().__init__()
        self.denoiser = denoiser
        self.dtype = dtype
        self.cast_params = cast_params
        self._slots = None
        self._cast_cache = None

    def _float32_slots(self):
        """``(dict, name)`` of every float32 parameter and buffer of the
        denoiser, indexed once per wrapped module (a parameter or buffer
        registered after the first call is not cast)."""
        if self._slots is None or self._slots[0] is not self.denoiser:
            index = [(d, n) for m in self.denoiser.modules() for d in (m._parameters, m._buffers)
                     for n, t in d.items() if t is not None and t.dtype == torch.float32]
            self._slots = (self.denoiser, index)
        return self._slots[1]

    def _casts(self, tensors):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return [t.to(self.dtype) for t in tensors]
        key = tuple((t.data_ptr(), t._version, t.device) for t in tensors)
        if self._cast_cache is None or self._cast_cache[0] != key:
            with torch.no_grad():
                self._cast_cache = (key, [t.to(self.dtype) for t in tensors])
        return self._cast_cache[1]

    @contextlib.contextmanager
    def _cast(self):
        """The denoiser's float32 tensors replaced by their casts inside the
        block, restored on exit."""
        slots = self._float32_slots()
        tensors = [d[n] for d, n in slots]
        for (d, n), c in zip(slots, self._casts(tensors)):
            d[n] = c
        try:
            yield
        finally:
            for (d, n), t in zip(slots, tensors):
                d[n] = t

    def forward(self, x, sigma=None, **kwargs):
        ctx = self._cast() if self.cast_params else contextlib.nullcontext()
        with ctx:
            return self.denoiser(x.to(self.dtype), sigma, **kwargs).to(x.dtype)


def autocast(denoiser: nn.Module, dtype=torch.bfloat16,
             cast_params: bool = True) -> AutocastDenoiser:
    """Wrap a denoiser for bf16 compute (precision.py:65)."""
    return AutocastDenoiser(denoiser, dtype=dtype, cast_params=cast_params)

"""Temporal and stochastic transforms (port of
deepinv_tpu/transform/temporal.py): :class:`ShiftTime`, :class:`RandomNoise`
and :class:`RandomPhaseError`."""

from __future__ import annotations

import math

import torch

from .base import Transform, _device

__all__ = ["ShiftTime", "RandomNoise", "RandomPhaseError"]


class ShiftTime(Transform):
    """Shift along the time axis of ``(B, C, T, H, W)`` data
    (temporal.py:16): ``padding='reflect'`` mirrors at the clip's ends,
    ``'wrap'`` rolls."""

    def __init__(self, *args, padding: str = "reflect", **kwargs):
        super().__init__(*args, **kwargs)
        if padding not in ("reflect", "wrap"):
            raise ValueError(f"padding must be one of ('reflect', 'wrap'), got {padding}")
        self.padding = padding

    @staticmethod
    def roll_reflect_1d(x, by=0, axis: int = 0):
        """Roll with reflect padding (temporal.py:30): the signal padded on
        both sides by its flip (``T - 1`` each), rolled, the centre taken."""
        T = x.shape[axis]
        by = int(by) % (2 * T - 2) if T > 1 else 0
        if by > T - 1:
            by -= 2 * T - 2
        xf = torch.flip(x, (axis,))
        pad = torch.cat([xf.narrow(axis, 0, T - 1), x, xf.narrow(axis, 1, T - 1)], axis)
        idx = (torch.arange(T, device=x.device) + (T - 1) - by) % (3 * T - 2)
        return torch.index_select(pad, axis, idx)

    def get_params(self, x, generator=None):
        """``t_shift`` on ``[-T // 2, T // 2]`` per output sample
        (temporal.py:51)."""
        T = x.shape[2]
        n = self.n_trans * x.shape[0]
        s = torch.randint(-T // 2, T // 2 + 1, (n,), generator=generator,
                          device=_device(x, generator))
        return {"t_shift": s.to(x.device)}

    def transform(self, x, t_shift=None):
        x = self._repeat(x) if x.shape[0] != len(t_shift) else x
        if self.padding == "wrap":
            return torch.stack([torch.roll(v, int(s), 1) for v, s in zip(x, t_shift)])
        return torch.stack([self.roll_reflect_1d(v, s, axis=1) for v, s in zip(x, t_shift)])


class RandomNoise(Transform):
    """Additive noise as an augmentation (temporal.py:66): not a group
    action, its inverse is the identity.

    :param noise_type: ``gaussian`` (std ``sigma``) or uniform on
        ``[-sigma, sigma)``.
    """

    def __init__(self, sigma: float = 0.1, noise_type: str = "gaussian", **kwargs):
        super().__init__(**kwargs)
        self.sigma = sigma
        self.noise_type = noise_type

    def get_params(self, x, generator=None):
        shape = (self.n_trans * x.shape[0],) + tuple(x.shape[1:])
        dev = _device(x, generator)
        if self.noise_type == "gaussian":
            eps = torch.randn(shape, generator=generator, device=dev) * self.sigma
        else:
            eps = (torch.rand(shape, generator=generator, device=dev) * 2 - 1) * self.sigma
        return {"eps": eps.to(x.device)}

    def invert_params(self, params):
        return {"eps": torch.zeros_like(params["eps"])}

    def transform(self, x, eps=None):
        x = self._repeat(x) if x.shape[0] != eps.shape[0] else x
        return x + eps


class RandomPhaseError(Transform):
    """A random phase on each k-space line (the last axis) of ``(B, 2, ...,
    H, W)`` real/imaginary data (temporal.py:92), ``N(0, (scale pi)^2)``
    radians."""

    def __init__(self, scale: float = 0.1, **kwargs):
        super().__init__(**kwargs)
        self.scale = scale

    def get_params(self, x, generator=None):
        n = self.n_trans * x.shape[0]
        phase = torch.randn((n, x.shape[-1]), generator=generator,
                            device=_device(x, generator)) * self.scale * math.pi
        return {"phase": phase.to(x.device)}

    def invert_params(self, params):
        return {"phase": -params["phase"]}

    def transform(self, x, phase=None):
        x = self._repeat(x) if x.shape[0] != phase.shape[0] else x
        c = torch.complex(x[:, 0:1], x[:, 1:2])
        ph = torch.polar(torch.ones_like(phase), phase)[:, None]
        while ph.dim() < c.dim():
            ph = ph.unsqueeze(-2)
        c = c * ph
        return torch.cat([c.real, c.imag], 1)

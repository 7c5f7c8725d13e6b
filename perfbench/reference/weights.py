"""Seeded network weights, drawn on the device in one call.

A spec is ``[(name, shape, std)]``; each leaf is a slice of one standard
normal draw of the total size, scaled by its ``std``. A ``std`` of 0 is a
leaf left at zero.
"""

import math

import torch


def draw(specs, generator, device):
    total = sum(math.prod(shape) for _, shape, _ in specs)
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    out, o = {}, 0
    for name, shape, std in specs:
        n = math.prod(shape)
        out[name] = (flat[o:o + n] * std).reshape(shape)
        o += n
    return out


def he_std(fan_in, gain=1.0):
    """Kaiming-normal (fan-in) standard deviation times ``gain``."""
    return gain * math.sqrt(2.0 / fan_in)

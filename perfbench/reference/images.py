"""Seeded test images, made on the device.

Each channel is white noise shaped by the ``1 / (1 + (f / f0)^2)`` spectrum of
natural images (``f0`` in cycles per pixel), then scaled to [0, 1] per image
and channel: smooth fields with edges at every scale, no two alike.
"""

import torch


def smooth_fields(n, channels, height, width, generator, device, f0=0.02):
    w = torch.randn((n, channels, height, width), generator=generator, device=device)
    fy = torch.fft.fftfreq(height, device=device)[:, None]
    fx = torch.fft.rfftfreq(width, device=device)[None, :]
    shape = 1.0 / (1.0 + (fy ** 2 + fx ** 2) / f0 ** 2)
    x = torch.fft.irfft2(torch.fft.rfft2(w) * shape, s=(height, width))
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) / (hi - lo)

"""Liu-Jia padding for deconvolution of a valid blur (port of
examples/demo_liu_jia_padding.py): a 128x128 scene whose opposite borders
differ, blurred by a 7x7 Gaussian with the valid crop and noise 1e-3. Wiener
and inverse filtering under the circular model ring at the border of the
crop; padding the measurement by Liu and Jia's method first makes it
circular-consistent, and both filters gain.
"""

import math

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..ops import gaussian_blur
from ..physics import Blur, GaussianNoise
from ..physics.functional import liu_jia_pad
from . import _util


def psf_otf(filt, shape):
    """The PSF zero-padded to ``shape`` and centred at the origin: its OTF."""
    kh, kw = filt.shape[-2:]
    k = torch.zeros(shape, dtype=filt.dtype, device=filt.device)
    k[:kh, :kw] = filt[0, 0]
    return torch.fft.fft2(torch.roll(k, shifts=(-(kh // 2), -(kw // 2)), dims=(0, 1)))


def wiener(y, otf, balance):
    X = otf.conj() * torch.fft.fft2(y) / (otf.abs() ** 2 + balance)
    return torch.fft.ifft2(X).real


def main(device=None, fast=False):
    dev = _util.device(device)
    sigma_blur, sigma_noise = 1.0, 1e-3
    ksize = 6 * math.ceil(sigma_blur) + 1
    kernel = gaussian_blur(sigma=sigma_blur, psf_size=(ksize, ksize))
    # a scene whose opposite borders are decorrelated: circles and a ramp
    x = torch.from_numpy(random_circles(128, seed=2))[None] * 0.5 \
        + torch.linspace(0.0, 0.8, 128)[None, None, :, None]
    # the realistic observation: the valid (cropped) convolution and noise
    physics = Blur(filter=kernel, padding="valid",
                   noise_model=GaussianNoise(sigma_noise, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0)).to(dev)
    crop = ksize // 2
    x_in = x[..., crop:-crop, crop:-crop].to(dev)  # the truth aligned with y
    kernel = kernel.to(dev)
    psnr = PSNR()
    out = {"psnr_blurry": float(psnr(y, x_in)[0])}
    print(f"valid-blurred observation: {tuple(y.shape)}, blurry PSNR {out['psnr_blurry']:.2f} dB")
    pad = 2 * ksize
    otf = psf_otf(kernel, y.shape[-2:])
    y_pad = liu_jia_pad(y, padding=(pad, pad))
    otf_p = psf_otf(kernel, y_pad.shape[-2:])
    for name, balance in (("wiener", 10 * sigma_noise), ("inverse", 1e-6)):
        # the circular model on the crop rings at the border; padded first, it
        # is circular-consistent
        naive = wiener(y, otf, balance)
        lj = wiener(y_pad, otf_p, balance)[..., pad:-pad, pad:-pad]
        out[f"psnr_{name}_no_pad"] = float(psnr(naive, x_in)[0])
        out[f"psnr_{name}_liu_jia"] = float(psnr(lj, x_in)[0])
        print(f"{name:7s} filter, no padding: {out[f'psnr_{name}_no_pad']:.2f} dB; Liu-Jia "
              f"padding: {out[f'psnr_{name}_liu_jia']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Quickstart: measure, reconstruct, evaluate (port of
examples/demo_quickstart.py).

Inpainting of a 64x64 image of random circles with 40% of its pixels
missing and noise 0.05, reconstructed by 20 iterations of PnP-PGD with a
3x3 median filter; the reconstruction's PSNR beats the measurement's.
"""

import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..models import MedianFilter
from ..optim import L2, PnP, optim_builder
from ..physics import GaussianNoise, Inpainting
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=0))[None]
    physics = Inpainting((1, 64, 64), mask=0.6, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.05, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)

    model = optim_builder("PGD", data_fidelity=L2(), prior=PnP(MedianFilter(kernel_size=3)),
                          params_algo={"stepsize": 1.0, "g_param": 0.05}, max_iter=20,
                          device=dev)
    with torch.no_grad():
        xhat = model(y, physics)

    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x)[0]), "psnr_xhat": float(psnr(xhat, x)[0])}
    print(f"PSNR measurement: {out['psnr_y']:.2f} dB")
    print(f"PSNR reconstruction: {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

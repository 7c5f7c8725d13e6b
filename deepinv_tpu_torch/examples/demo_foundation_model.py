"""One model for any operator (port of examples/demo_foundation_model.py):
a narrow RAM (widths 16, 32, 64, 64, two blocks a scale, random weights
from a seed) consumes denoising (1 channel), 50% inpainting (3 channels)
and Gaussian deblurring (3 channels) of 64x64 images with no retraining;
each output has its ground truth's shape and is finite. Pass
``pretrained=`` a local checkpoint with the default widths for the
published weights.
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..models import RAM
from ..ops import gaussian_blur
from ..physics import BlurFFT, Denoising, GaussianNoise, Inpainting
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    model = RAM(nc=(16, 32, 64, 64), nb=2, generator=_util.generator(0), device=dev)
    x1 = torch.from_numpy(random_circles(64, seed=0))[None]
    x3 = torch.from_numpy(np.stack([random_circles(64, seed=1, channels=3)]))
    tasks = [("denoising (1ch)", x1, Denoising(noise_model=GaussianNoise(0.1, device="cpu"))),
             ("inpainting (3ch)", x3,
              Inpainting((3, 64, 64), mask=0.5, generator=_util.generator(1),
                         noise_model=GaussianNoise(0.05, device="cpu"), device="cpu")),
             ("deblurring (3ch)", x3,
              BlurFFT((3, 64, 64), filter=gaussian_blur(sigma=1.5),
                      noise_model=GaussianNoise(0.02, device="cpu"), device="cpu"))]
    out = {"shape_ok": {}, "finite": {}}
    for name, x, physics in tasks:
        y = physics(x, generator=_util.generator(42))
        physics, y = physics.to(dev), y.to(dev)
        with torch.no_grad():
            xhat = model(y, physics)  # the same model, any physics
        out["shape_ok"][name] = tuple(xhat.shape) == tuple(x.shape)
        out["finite"][name] = bool(torch.isfinite(xhat).all())
        print(f"{name:>17s}: y {tuple(y.shape)} -> x_hat {tuple(xhat.shape)} (one model, "
              f"zero-shot API)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

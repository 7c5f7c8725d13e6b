"""DEAL as a denoiser and as a reconstructor (port of
examples/demo_deal_reconstruction.py): the same model (random weights from a
seed, 5 iterations, lambda 2) denoises a 32x32 image at noise 0.1 with
``model(y, sigma)``, its output clamped to [0, 1], and reconstructs from a
60% inpainting measurement with ``model(y, physics)``.
"""

import torch

from ..datasets import random_circles
from ..models import DEAL
from ..physics import GaussianNoise, Inpainting
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(32, seed=0))[None]
    model = DEAL(color=False, max_iter=5, lambda_reg=2.0, generator=_util.generator(0), device=dev)
    noisy = (x + 0.1 * torch.randn(x.shape, generator=_util.generator(1))).to(dev)
    physics = Inpainting((1, 32, 32), mask=0.6, generator=_util.generator(2),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(3))
    physics, y = physics.to(dev), y.to(dev)
    with torch.no_grad():
        den = model(noisy, 0.1)  # the denoiser's convention: model(y, sigma)
        xhat = model(y, physics)  # the reconstructor's: model(y, physics)
    out = {"denoised_min": float(den.min()), "denoised_max": float(den.max()),
           "denoised_shape": list(den.shape), "xhat_shape": list(xhat.shape),
           "xhat_finite": bool(torch.isfinite(xhat).all())}
    print(f"denoised range: {out['denoised_min']} {out['denoised_max']}")
    print(f"reconstruction shape: {tuple(xhat.shape)}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

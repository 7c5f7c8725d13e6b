"""PnP mirror descent for Poisson denoising (port of
examples/demo_pnp_mirror_descent.py): 50 iterations of mirror descent in
Burg's entropy with the Poisson likelihood at gain 0.01 and RED's gradient
of a 3x3 median filter, on a 64x64 image kept inside the positive orthant.
"""

import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..models import MedianFilter
from ..optim import RED, BurgEntropy, PoissonLikelihood, optim_builder
from ..physics import Denoising, PoissonNoise
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    gain = 0.01
    # keep the signal well inside the positive orthant (Burg geometry)
    x = torch.from_numpy(random_circles(64, seed=2))[None] * 0.7 + 0.2
    physics = Denoising(noise_model=PoissonNoise(gain=gain, device="cpu"))
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)

    model = optim_builder("MD", data_fidelity=PoissonLikelihood(gain=gain),
                          # mirror descent needs a prior gradient: RED's x - D(x)
                          prior=RED(MedianFilter(kernel_size=3)),
                          bregman_potential=BurgEntropy(),
                          params_algo={"stepsize": 0.01, "g_param": 0.05, "lambda": 1.0},
                          max_iter=50, device=dev)
    with torch.no_grad():
        xhat = model(y, physics)
    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x)[0]), "psnr_xhat": float(psnr(xhat, x)[0])}
    print(f"noisy: {out['psnr_y']:.2f} dB, PnP-MD: {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""RED super-resolution (port of examples/demo_red_sr.py): 40 steps of
gradient descent on ``||Ax - y||^2`` plus RED's ``x - D(x)`` of a db4
wavelet denoiser, for 2x Gaussian downsampling of a 64x64 image with noise
0.01, against the zero-filled upsampling.
"""

import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..models import WaveletDenoiser
from ..optim import L2, RED, optim_builder
from ..physics import Downsampling, GaussianNoise
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=3))[None]
    physics = Downsampling((1, 64, 64), factor=2, filter="gaussian",
                           noise_model=GaussianNoise(0.01, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)

    model = optim_builder("GD", data_fidelity=L2(), prior=RED(WaveletDenoiser(wv="db4", level=3)),
                          params_algo={"stepsize": 1.0, "g_param": 0.03, "lambda": 0.5},
                          max_iter=40, device=dev)
    with torch.no_grad():
        xhat = model(y, physics)
        naive = physics.A_adjoint(y) * 4  # zero-fill upsampling baseline
    psnr = PSNR()
    out = {"psnr_naive": float(psnr(naive, x)[0]), "psnr_xhat": float(psnr(xhat, x)[0])}
    print(f"upsampled adjoint: {out['psnr_naive']:.2f} dB, RED: {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

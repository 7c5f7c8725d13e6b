"""Wavelet and TV priors in PGD (port of examples/demo_wavelet_prior.py):
100 iterations each of PGD with the l1 norm of db4 and Haar wavelet
coefficients and with TV (the Chambolle kernel on the card), at lambda
0.02, on 64x64 inpainting (40% of the pixels kept, noise 0.02). The three
reconstructions are returned under ``x_hat``.
"""

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..optim import L2, TVPrior, WaveletPrior, optim_builder
from ..physics import GaussianNoise, Inpainting
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=4))[None]
    physics = Inpainting((1, 64, 64), mask=0.4, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    psnr = PSNR()
    out = {"psnr_masked": float(psnr(physics.A_adjoint(y), x)[0]), "x_hat": {}}
    print(f"masked-input PSNR: {out['psnr_masked']:.2f} dB")
    for key, name, prior in [("psnr_db4", "db4 wavelet", WaveletPrior(wv="db4", level=3)),
                             ("psnr_haar", "haar wavelet", WaveletPrior(wv="haar", level=3)),
                             ("psnr_tv", "TV", TVPrior())]:
        model = optim_builder("PGD", data_fidelity=L2(), prior=prior,
                              params_algo={"stepsize": 1.0, "lambda": 0.02, "g_param": 1.0},
                              max_iter=_util.scale(100, 25, fast), device=dev)
        with torch.no_grad():
            out["x_hat"][key[5:]] = model(y, physics)
            out[key] = float(psnr(out["x_hat"][key[5:]], x)[0])
        print(f"PGD + {name:>12s}: {out[key]:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

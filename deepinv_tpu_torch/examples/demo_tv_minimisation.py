"""TV minimisation by three splitting algorithms (port of
examples/demo_tv_minimisation.py): PGD, ADMM and Chambolle-Pock, 30
iterations each with a 20-step TV prox (the Chambolle kernel on the card),
on a 64x64 image blurred by a Gaussian of width 2 with noise 0.02. Each
stays within 0.5 dB of the measurement or above it. The three
reconstructions are returned under ``x_hat``.
"""

import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..ops import gaussian_blur
from ..optim import L2, TVPrior, optim_builder
from ..physics import BlurFFT, GaussianNoise
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=0))[None]
    physics = BlurFFT((1, 64, 64), filter=gaussian_blur(sigma=2.0),
                      noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x)[0]), "x_hat": {}}
    print(f"measurement PSNR: {out['psnr_y']:.2f} dB")
    for algo, params in [("PGD", {"stepsize": 1.0, "lambda": 0.05}),
                         ("ADMM", {"stepsize": 0.5, "lambda": 0.05}),
                         ("CP", {"stepsize": 0.5, "sigma": 1.0, "lambda": 0.05})]:
        model = optim_builder(algo, data_fidelity=L2(), prior=TVPrior(n_it_max=20),
                              params_algo=params, max_iter=_util.scale(30, 10, fast), device=dev)
        with torch.no_grad():
            out["x_hat"][algo.lower()] = model(y, physics)
            out[f"psnr_{algo.lower()}"] = float(psnr(out["x_hat"][algo.lower()], x)[0])
        print(f"{algo}: PSNR {out[f'psnr_{algo.lower()}']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

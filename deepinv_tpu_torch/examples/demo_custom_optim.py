"""Building a custom optimization algorithm (port of
examples/demo_custom_optim.py).

Any ``OptimIterator``, one state dict in and one out, plugs into
``optim_builder`` and gets the engine's per-iteration schedules. Here a
heavy-ball (momentum) proximal gradient iterator, compared with plain PGD on
deblurring a 64x64 image of random circles (Gaussian blur 1.5, noise 0.02)
with a median-filter prior.
"""

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import MedianFilter
from ..ops import gaussian_blur
from ..optim import L2, PnP, optim_builder
from ..optim.iterators import OptimIterator
from ..physics import BlurFFT, GaussianNoise
from . import _util


class HeavyBallPGDIteration(OptimIterator):
    """Proximal gradient with Polyak momentum: the state carries the previous
    iterate and adds ``beta (x_k - x_{k-1})`` before the gradient step."""

    def init_state(self, x_init, y, physics):
        return {"est": (x_init, x_init), "x_prev": x_init, "it": 0}

    def forward(self, X, data_fidelity, prior, params, y, physics):
        x, x_prev = X["est"][0], X["x_prev"]
        v = x + params.get("beta", 0.5) * (x - x_prev)
        z = v - params["stepsize"] * data_fidelity.grad(v, y, physics)
        x_new = prior.prox(z, params.get("g_param"), gamma=params["lambda"] * params["stepsize"])
        return {"est": (x_new, z), "x_prev": x, "it": X["it"] + 1}


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=1))[None]
    physics = BlurFFT((1, 64, 64), filter=gaussian_blur(sigma=1.5),
                      noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    psnr = PSNR()

    common = dict(data_fidelity=L2(), prior=PnP(MedianFilter(kernel_size=3)), max_iter=20,
                  device=dev)
    pgd = optim_builder("PGD", params_algo={"stepsize": 1.0, "g_param": 0.1, "lambda": 1.0},
                        **common)
    custom = optim_builder(HeavyBallPGDIteration(),
                           params_algo={"stepsize": 1.0, "g_param": 0.1, "lambda": 1.0,
                                        "beta": 0.4}, **common)
    with torch.no_grad():
        out = {"psnr_y": float(psnr(y, x)[0]), "psnr_pgd": float(psnr(pgd(y, physics), x)[0]),
               "psnr_heavy_ball": float(psnr(custom(y, physics), x)[0])}
    print(f"measurement      PSNR: {out['psnr_y']:6.2f} dB")
    print(f"PnP-PGD          PSNR: {out['psnr_pgd']:6.2f} dB")
    print(f"PnP heavy-ball   PSNR: {out['psnr_heavy_ball']:6.2f} dB "
          f"(custom iterator, same engine)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

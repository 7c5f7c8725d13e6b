"""Coarse-to-fine PnP (port of examples/demo_pnp_multiscale.py): 30 PnP-PGD
iterations at half resolution through ``LinearPhysicsMultiScaler``, the
iterate upsampled, then 10 at full resolution, against 40 at full
resolution, on 64x64 inpainting (30% of the pixels kept, noise 0.02).
"""

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import WaveletDenoiser
from ..optim import L2, PnP, optim_builder
from ..physics import GaussianNoise, Inpainting, LinearPhysicsMultiScaler
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=5))[None]
    base = Inpainting((1, 64, 64), mask=0.3, generator=_util.generator(0),
                      noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = base(x, generator=_util.generator(1))
    base, x, y = base.to(dev), x.to(dev), y.to(dev)
    psnr = PSNR()
    ms = LinearPhysicsMultiScaler(base, img_size=(1, 64, 64), factors=(2, 4, 8), device=dev)
    prior = PnP(WaveletDenoiser("db4", 2))

    def pnp(physics_s, y_s, x_init, iters):
        model = optim_builder("PGD", data_fidelity=L2(), prior=prior,
                              params_algo={"stepsize": 1.0, "g_param": 0.05}, max_iter=iters,
                              device=dev)
        return model(y_s, physics_s, x_init=x_init)

    with torch.no_grad():
        # single scale: every iteration at the fine scale
        x_fine = pnp(base, y, None, 40)
        # coarse to fine: 30 iterations on the 2x coarser grid, upsampled,
        # then 10 at the fine scale
        x1 = pnp(ms.with_scale(1), y, None, 30)
        x0_init = ms.upsample(x1, scale=1)
        x_c2f = pnp(base, y, x0_init, 10)
    out = {"psnr_y": float(psnr(y, x)[0]), "psnr_fine": float(psnr(x_fine, x)[0]),
           "psnr_c2f": float(psnr(x_c2f, x)[0]), "psnr_coarse_up": float(psnr(x0_init, x)[0])}
    print(f"single-scale PnP (40 fine its): {out['psnr_fine']:.2f} dB")
    print(f"coarse-to-fine PnP (30 coarse + 10 fine): {out['psnr_c2f']:.2f} dB")
    print(f"coarse iterate upsampled (no fine its): {out['psnr_coarse_up']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

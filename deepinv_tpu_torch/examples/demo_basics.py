"""First steps (port of examples/demo_basics.py): define a physics,
measure, reconstruct three ways (the pseudo-inverse, TV-regularized PGD, and
PnP-HQS with a TV denoiser) and score them.

The Shepp-Logan phantom at 64x64 with half its pixels masked and noise
0.05. Both TV reconstructions run the isotropic-TV prox, the Chambolle
kernel on the card; they are returned under ``x_hat``.
"""

import torch

from ..datasets import shepp_logan
from ..loss.metric import PSNR, SSIM
from ..models import TVDenoiser
from ..optim import L2, PnP, TVPrior, optim_builder
from ..physics import GaussianNoise, Inpainting
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    # 1. ground truth and forward operator
    x = torch.from_numpy(shepp_logan(64))[None, None]
    physics = Inpainting((1, 64, 64), mask=0.5, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.05, device="cpu"), device="cpu")
    # 2. measure (the randomness is explicit: a generator)
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    psnr, ssim = PSNR(), SSIM()
    out = {"psnr_y": float(psnr(y, x)[0]), "ssim_y": float(ssim(y, x)[0]), "x_hat": {}}
    print(f"measurement      PSNR {out['psnr_y']:5.2f}  SSIM {out['ssim_y']:.3f}")

    with torch.no_grad():
        # 3a. the linear pseudo-inverse
        out["psnr_dagger"] = float(psnr(physics.A_dagger(y), x)[0])
        print(f"pseudo-inverse   PSNR {out['psnr_dagger']:5.2f}")
        # 3b. variational: TV-regularized proximal gradient
        tv = optim_builder("PGD", data_fidelity=L2(), prior=TVPrior(),
                           params_algo={"stepsize": 1.0, "lambda": 0.02},
                           max_iter=_util.scale(50, 20, fast), device=dev)
        out["x_hat"]["tv"] = tv(y, physics)
        out["psnr_tv"] = float(psnr(out["x_hat"]["tv"], x)[0])
        print(f"TV-PGD           PSNR {out['psnr_tv']:5.2f}")
        # 3c. plug-and-play: any denoiser as the prior
        pnp = optim_builder("HQS", data_fidelity=L2(), prior=PnP(TVDenoiser(50)),
                            params_algo={"stepsize": 1.0, "g_param": 0.03}, max_iter=10,
                            device=dev)
        out["x_hat"]["pnp"] = pnp(y, physics)
        out["psnr_pnp"] = float(psnr(out["x_hat"]["pnp"], x)[0])
        print(f"PnP-HQS          PSNR {out['psnr_pnp']:5.2f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

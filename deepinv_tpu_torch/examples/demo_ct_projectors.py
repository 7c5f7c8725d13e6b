"""The three parallel-beam CT projectors (port of
examples/demo_ct_projectors.py): the interpolating Radon transform, the
Fourier-slice and the slice projector, each on a 128x128 Shepp-Logan phantom
at 60 angles with noise 0.002 on the normalised sinogram. Each backend
reconstructs by the FBP and by 30 TV-PGD iterations warm-started from it
(the TV prox is the Chambolle kernel on the card); TV-PGD beats the FBP on
each. The fast mode takes 32x32 and 10 iterations. The TV-PGD
reconstructions are returned under ``x_hat``.
"""

import torch

from ..datasets import shepp_logan
from ..loss.metric import PSNR
from ..optim import L2, TVPrior, optim_builder
from ..physics import GaussianNoise, Tomography
from . import _util

METHODS = ("interp", "fourier", "slice")


def main(device=None, fast=False):
    dev = _util.device(device)
    size = 32 if fast else 128
    x = torch.from_numpy(shepp_logan(size))[None, None]
    psnr = PSNR()
    out = {"x_hat": {}}
    for method in METHODS:
        # normalize=True scales the sinogram by 1/W: the noise level is
        # relative to that scale
        physics = Tomography(angles=60, img_width=size, method=method, normalize=True,
                             noise_model=GaussianNoise(0.002, device="cpu"), device="cpu")
        y = physics(x, generator=_util.generator(0))
        physics, xd, y = physics.to(dev), x.to(dev), y.to(dev)
        with torch.no_grad():
            fbp = physics.A_dagger(y)
            model = optim_builder("PGD", data_fidelity=L2(), prior=TVPrior(),
                                  params_algo={"stepsize": 1.0, "lambda": 5e-4},
                                  max_iter=_util.scale(30, 10, fast),
                                  custom_init=lambda yv, p: p.A_dagger(yv), device=dev)
            rec = model(y, physics)
        out[f"psnr_fbp_{method}"] = float(psnr(fbp, xd)[0])
        out[f"psnr_tv_{method}"] = float(psnr(rec, xd)[0])
        out["x_hat"][method] = rec
        print(f"{method:8s}  FBP {out[f'psnr_fbp_{method}']:5.2f} dB   "
              f"TV-PGD {out[f'psnr_tv_{method}']:5.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

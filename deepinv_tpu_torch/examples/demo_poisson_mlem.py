"""MLEM for Poisson tomography (port of examples/demo_poisson_mlem.py): 30
MLEM iterations on a 64x64 Shepp-Logan phantom (plus 0.05) seen at 60
angles through Poisson noise of gain 0.01, against the FBP.
"""

import torch

from ..datasets import shepp_logan
from ..loss.metric import PSNR
from ..optim import PoissonLikelihood, Zero, optim_builder
from ..physics import PoissonNoise, Tomography
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(shepp_logan(64))[None, None] + 0.05
    physics = Tomography(img_width=64, angles=60, normalize=True,
                         noise_model=PoissonNoise(gain=0.01, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    model = optim_builder("MLEM", data_fidelity=PoissonLikelihood(gain=0.01), prior=Zero(),
                          params_algo={"stepsize": 1.0}, max_iter=_util.scale(30, 10, fast),
                          device=dev)
    with torch.no_grad():
        xhat = model(y, physics)
        fbp = physics.A_dagger(y)
    psnr = PSNR()
    out = {"psnr_fbp": float(psnr(fbp, x)[0]), "psnr_mlem": float(psnr(xhat, x)[0])}
    print(f"FBP PSNR : {out['psnr_fbp']:.2f} dB")
    print(f"MLEM PSNR: {out['psnr_mlem']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

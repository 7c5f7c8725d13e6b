"""Hand-rolled PnP (port of examples/demo_vanilla_pnp.py): 40 iterations of
a gradient step on ``||Ax - y||^2`` and a db4 wavelet denoiser at 0.06, a
plain loop over the physics and the denoiser, on 64x64 inpainting (half the
pixels, noise 0.03).
"""

import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..models import WaveletDenoiser
from ..physics import GaussianNoise, Inpainting
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=0))[None]
    physics = Inpainting((1, 64, 64), mask=0.5, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.03, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    den = WaveletDenoiser(wv="db4", level=3)

    # gradient step on ||Ax - y||^2, then denoise
    with torch.no_grad():
        z = physics.A_adjoint(y)
        for _ in range(40):
            z = den(z - physics.A_adjoint(physics.A(z) - y), 0.06)

    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x)[0]), "psnr_xhat": float(psnr(z, x)[0])}
    print(f"measurement: {out['psnr_y']:.2f} dB, vanilla PnP: {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

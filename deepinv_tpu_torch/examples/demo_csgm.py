"""Compressed sensing with a generative model (port of
examples/demo_csgm.py): a DCGAN generator (64x64, a latent of 16, 8
features) makes the ground truth from a random latent; 256 random
measurements of its 4096 pixels; the CSGM reconstructor fits the latent
from a random start (400 momentum steps, lr 2e-2) until the generator's
image reproduces the measurements. The measurement residual falls below a
quarter of the zero image's (the JAX demo asserts it).
"""

import torch

from ..models import CSGMGenerator, DCGANGenerator
from ..physics import CompressedSensing
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    steps = _util.scale(400, 200, fast)
    G = DCGANGenerator(output_size=64, nz=16, ngf=8, nc=1, generator=_util.generator(0),
                       device=dev)
    # the ground truth in the generator's range
    z_true = torch.randn((1, 16), generator=_util.generator(1)).to(dev)
    z0 = torch.randn((1, 16), generator=_util.generator(3)).to(dev)
    with torch.no_grad():
        x = G(z_true)
    physics = CompressedSensing(m=256, img_size=tuple(x.shape[1:]), generator=_util.generator(2),
                                device="cpu").to(dev)
    y = physics.A(x)
    model = CSGMGenerator(G, inf_max_iter=steps, inf_lr=2e-2)
    xhat = model(y, physics, z0=z0)
    with torch.no_grad():
        res0 = float(torch.linalg.norm(physics.A(torch.zeros_like(x)) - y))
        res = float(torch.linalg.norm(physics.A(xhat) - y))
        mse = float(((xhat - x) ** 2).mean())
    print(f"measurement residual: {res0:.3f} -> {res:.3f} ({steps} steps)")
    print(f"image MSE vs truth: {mse:.4f}")
    return {"residual_start": res0, "residual": res, "mse": mse}


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Mesh-parallel PnP over stacked operators (port of
examples/demo_distributed_pnp.py): 8 circular Gaussian blurs (sigma 1, 7x7)
of one 64x64 image, one operator a mesh entry, the data fidelity's gradient
summed over the stack by the distributed adjoint, and 20 PnP-PGD
iterations with a 3x3 median denoiser. The stacked adjoint sums 8
sub-adjoints, so ``||A^T A||`` is about 8 and the step 0.9 / 8. The error
falls below half the zero start's (the JAX demo asserts it).

The JAX demo runs on 8 virtual CPU devices. The port's mesh here has 8
entries on the one device the demo runs on (``devices=[device] * 8``): 8
mesh entries on one card, not 8 cards, the same split of the work.
"""

import torch

from ..datasets import random_circles
from ..models import MedianFilter
from ..ops import gaussian_blur
from ..optim import L2
from ..parallel import DistributedContext, distribute
from ..physics import Blur
from . import _util

MESH = 8  # the mesh's entries: the JAX demo's 8 virtual devices


def main(device=None, fast=False):
    dev = _util.device(device)
    ctx = DistributedContext(axis_names=("op",), devices=[dev] * MESH)
    n = ctx.axis_size()
    plist = [Blur(filter=gaussian_blur(sigma=1.0, psf_size=(7, 7)), padding="circular",
                  device=dev) for _ in range(n)]
    dphys = distribute(plist, ctx)
    dfid = distribute(L2(), ctx)

    x = torch.from_numpy(random_circles(64, seed=0))[None].to(dev)
    with torch.no_grad():
        y = dphys.A(x)
        z = torch.zeros_like(x)
        den = MedianFilter(3)
        # the stacked adjoint sums n sub-adjoints, so ||A^T A|| ~ n: the
        # step scales with it, or PGD diverges
        step = 0.9 / n
        for _ in range(20):
            z = den(z - step * dfid.grad(z, y, dphys))
    mse = float(((z - x) ** 2).mean())
    mse0 = float((x ** 2).mean())
    print(f"mse: {mse:.4f} (vs zero-init {mse0:.4f}) over a mesh of {n}")
    return {"mse": mse, "mse_zero": mse0, "mesh": n, "x_hat": {"pgd": z}}


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Operator-parallel stacked physics on a device mesh (port of
examples/demo_physics_distributed.py): a factory builds 8 circular Gaussian
blurs (sigma 0.5 + 0.25 i, 7x7), each where its mesh entry lives; ``A``
keeps the measurements stacked one an operator, ``A_adjoint`` sums the
operators' adjoints into one image, the stack passes the dot-product test,
and ``A_dagger`` runs 20 conjugate-gradient steps with every product
distributed: its relative error lies below 0.5 (the JAX demo asserts it).

The JAX demo runs on 8 virtual CPU devices. The port's mesh here has 8
entries on the one device the demo runs on (``devices=[device] * 8``): 8
mesh entries on one card, not 8 cards. ``chip_smoke.py`` runs it with TF32
off; run alone on a card, PyTorch's default (TF32 in cuDNN's convolutions)
holds.
"""

import torch

from ..datasets import random_circles
from ..ops import gaussian_blur
from ..parallel import DistributedContext, distribute
from ..physics import Blur
from . import _util

MESH = 8  # the mesh's entries: the JAX demo's 8 virtual devices


def main(device=None, fast=False):
    dev = _util.device(device)
    ctx = DistributedContext(axis_names=("op",), devices=[dev] * MESH)
    n = ctx.axis_size()
    print(f"mesh: {n} entries on axis 'op'")

    # the factory form: operator i is built where it lives, so that no
    # entry holds the whole stack
    def factory(idx, device, params):
        return Blur(filter=gaussian_blur(sigma=0.5 + 0.25 * idx, psf_size=(7, 7)),
                    padding="circular", device=device)

    dphys = distribute(factory, ctx, num_operators=n, type_object="linear_physics")
    x = torch.from_numpy(random_circles(64, seed=0))[None].to(dev)
    u = torch.randn(x.shape, generator=_util.generator(1)).to(dev)
    with torch.no_grad():
        y = dphys.A(x)                   # (n, ...) stacked measurements
        print(f"stacked measurements: {tuple(y.shape)} (operator-major)")
        xt = dphys.A_adjoint(y)          # the sum over the operators
        print(f"the adjoint gathers to the image: {tuple(xt.shape)}")
        # adjointness across the whole distributed stack
        v = torch.randn(y.shape, generator=_util.generator(2)).to(dev)
        lhs = float(torch.vdot(dphys.A(u).flatten(), v.flatten()))
        rhs = float(torch.vdot(u.flatten(), dphys.A_adjoint(v).flatten()))
        print(f"adjointness: {lhs:.4f} vs {rhs:.4f}")
        # the distributed CG pseudo-inverse: every product crosses the mesh
        xd = dphys.A_dagger(y, max_iter=20)
    rel = float(torch.linalg.norm(xd - x) / torch.linalg.norm(x))
    print(f"A_dagger (distributed CG, 20 it): rel err {rel:.3f}")
    return {"mesh": n, "y_shape": list(y.shape), "adjoint_shape": list(xt.shape),
            "adjointness_lhs": lhs, "adjointness_rhs": rhs,
            "adjointness_gap": abs(lhs - rhs) / abs(lhs), "rel": rel,
            "x_hat": {"A": y, "A_adjoint": xt, "A_dagger": xd}}


if __name__ == "__main__":
    _util.cli(main, __doc__)

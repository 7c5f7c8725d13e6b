"""Defining a new physics operator (port of
examples/demo_custom_physics.py): subclass ``LinearPhysics`` with ``A``
alone, and the adjoint (autograd's transpose, from ``img_shape``), the
pseudo-inverse and the prox come with it; the adjoint passes the
dot-product test.
"""

import torch

from ..physics import GaussianNoise, LinearPhysics
from . import _util


class RowSum(LinearPhysics):
    """Toy operator: ``y`` is the mean of the image's rows."""

    def __init__(self, img_size, **kwargs):
        # img_shape lets the base class derive the exact adjoint by autograd
        super().__init__(img_shape=(1,) + tuple(img_size), **kwargs)
        self.img_size = tuple(img_size)

    def A(self, x, **params):
        return x.mean(dim=-2)


def main(device=None, fast=False):
    dev = _util.device(device)
    physics = RowSum((1, 16, 16), noise_model=GaussianNoise(0.01, device="cpu"))
    x = torch.rand((2, 1, 16, 16), generator=_util.generator(0))
    y = physics(x, generator=_util.generator(1))
    u = torch.randn(x.shape, generator=_util.generator(2))
    v = torch.randn(y.shape, generator=_util.generator(3))
    physics, x, y, u, v = physics.to(dev), x.to(dev), y.to(dev), u.to(dev), v.to(dev)
    print("measurement shape:", tuple(y.shape))

    # the adjoint is derived automatically and passes the dot-product test
    lhs = torch.vdot(physics.A(u).flatten(), v.flatten())
    rhs = torch.vdot(u.flatten(), physics.A_adjoint(v).flatten())
    out = {"adjointness_error": abs(float(lhs - rhs))}
    print(f"adjointness error: {out['adjointness_error']:.2e}")

    # the pseudo-inverse (Krylov) and prox_l2 come for free as well
    xdag = physics.A_dagger(physics.A(x))
    out["dagger_residual"] = float((physics.A(xdag) - physics.A(x)).abs().max())
    print("A A_dagger A ~ A residual:", out["dagger_residual"])
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

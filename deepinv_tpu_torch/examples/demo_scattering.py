"""Inverse scattering (port of examples/demo_scattering.py): a weak 32x32
permittivity contrast under 32 sources and 48 receivers, where the Born
operator approximates the full Lippmann-Schwinger model (relative
difference < 0.1); the Born inversion of the nonlinear data (Tikhonov
least squares, 300 iterations) within 0.6 relative error; and at 20 times
the contrast a larger Born error (multiple scattering).
"""

import torch

from ..datasets import random_circles
from ..physics import BornOperator, Scattering
from . import _util


def rel(a, b) -> float:
    return float((a - b).norm() / a.norm())


def main(device=None, fast=False):
    dev = _util.device(device)
    H = W = 32
    # a weak contrast, so that the Born linearization is accurate
    x = 0.01 * torch.from_numpy(random_circles(H, seed=9)).reshape(1, 1, H, W).to(dev)
    # 32 x 48 = 1536 measurements for 1024 unknowns: a well-posed inversion
    kw = dict(img_size=(H, W), n_sources=32, n_receivers=48, device=dev)
    born, full = BornOperator(**kw), Scattering(**kw, max_iter=60)
    with torch.no_grad():
        y_born, y_full = born.A(x), full.A(x)
        out = {"born_error": rel(y_full, y_born)}
        print(f"measurements {tuple(y_full.shape)}  Born vs full rel. diff "
              f"{out['born_error']:.4f}")
        # gamma is the data weight of min gamma/2 ||Ax-y||^2 + 1/2 ||x||^2
        x_hat = born.A_dagger(y_full, gamma=1e3, max_iter=_util.scale(300, 100, fast)).real
        out["inversion_error"] = float((x_hat - x).norm() / x.norm())
        print(f"Born inversion relative error: {out['inversion_error']:.3f}")
        # multiple scattering grows with the contrast
        out["strong_born_error"] = rel(full.A(20.0 * x), born.A(20.0 * x))
    print(f"strong contrast: Born vs full rel. diff {out['strong_born_error']:.3f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

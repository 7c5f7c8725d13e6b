"""3-D microscopy (port of examples/demo_microscopy_3d.py): a confocal PSF
(oil immersion, NA 1.37, 489/395 nm, 5x13x13) blurs a 12x48x48 volume of 25
fluorescent beads under Poisson-Gaussian noise; the volumetric operator's
adjointness, and 40 PGD iterations with a 3-D db2 wavelet prior against the
widefield measurement.
"""

import numpy as np
import torch

from ..loss import PSNR
from ..optim import L2, WaveletPrior, optim_builder
from ..physics import Blur, PoissonGaussianNoise
from ..physics.generator import ConfocalBlurGenerator3D
from . import _util


def bead_volume(D=12, H=48, W=48, n=25, seed=0) -> np.ndarray:
    """Sparse fluorescent beads in a dark volume."""
    r = np.random.default_rng(seed)
    v = np.zeros((D, H, W), np.float32)
    z, y, x = r.integers(2, D - 2, n), r.integers(6, H - 6, n), r.integers(6, W - 6, n)
    for zi, yi, xi in zip(z, y, x):
        v[zi - 1:zi + 2, yi - 1:yi + 2, xi - 1:xi + 2] = 0.6
        v[zi, yi, xi] = 1.0
    return v


def main(device=None, fast=False):
    dev = _util.device(device)
    # the physical confocal PSF: oil immersion, NA 1.37, 489/395 nm
    gen = ConfocalBlurGenerator3D(psf_size=(5, 13, 13), zernike_index=(4, 5, 6), NI=1.51,
                                  NA=1.37, lambda_ill=489e-9, lambda_coll=395e-9, device="cpu")
    psf = gen.step(1, generator=_util.generator(0))["filter"]  # (1, 1, 5, 13, 13)
    print(f"confocal PSF {tuple(psf.shape)}, energy {float(psf.sum()):.3f}")
    x = torch.from_numpy(bead_volume())[None, None]  # (1, 1, D, H, W)
    physics = Blur(filter=psf, padding="circular",
                   noise_model=PoissonGaussianNoise(gain=0.02, sigma=0.01, device="cpu"),
                   device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    psnr = PSNR()
    with torch.no_grad():
        u = torch.randn(x.shape, generator=_util.generator(2)).to(dev)
        v = torch.randn(y.shape, generator=_util.generator(3)).to(dev)
        lhs = float(torch.vdot(physics.A(u).flatten(), v.flatten()))
        rhs = float(torch.vdot(u.flatten(), physics.A_adjoint(v).flatten()))
        print(f"adjointness: {lhs:.4f} vs {rhs:.4f}")
        model = optim_builder("PGD", data_fidelity=L2(),
                              prior=WaveletPrior(wv="db2", level=2, wvdim=3),
                              params_algo={"stepsize": 1.0, "lambda": 0.002, "g_param": 0.01},
                              max_iter=_util.scale(40, 10, fast), device=dev)
        xhat = model(y, physics)
    out = {"psf_energy": float(psf.sum()), "adjointness": abs(lhs - rhs) / abs(lhs),
           "psnr_y": float(psnr(y, x)[0]), "psnr_xhat": float(psnr(xhat, x)[0])}
    print(f"widefield (blurred)  PSNR: {out['psnr_y']:6.2f} dB")
    print(f"PGD + 3D wavelets    PSNR: {out['psnr_xhat']:6.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Radio interferometry (port of examples/demo_radio_interferometry.py): a
128x128 Shepp-Logan sky (64x64 in the fast mode) seen through 20000
visibilities (5000) of a dense, centrally concentrated uv coverage, noise
0.01. The dirty image (the adjoint over the operator's squared norm, from 20
power iterations) against 40 PnP-FISTA iterations (10) whose prior is a
20-step TV denoiser on the real part, the Chambolle kernel on the card. The
PnP-FISTA reconstruction is returned under ``x_hat``.
"""

import numpy as np
import torch

from ..datasets import shepp_logan
from ..loss import PSNR
from ..models import TVDenoiser
from ..optim import L2, PnP, optim_builder
from ..physics import GaussianNoise, RadioInterferometry
from . import _util


def uv_coverage(n_vis: int, seed: int = 0) -> np.ndarray:
    """``(2, n_vis)`` float32 sample locations in (-0.95 pi, 0.95 pi),
    normal with deviation pi/3: baselines cluster short."""
    uv = np.random.default_rng(seed).normal(size=(2, n_vis)) * (np.pi / 3)
    return np.clip(uv, -np.pi * 0.95, np.pi * 0.95).astype(np.float32)


def main(device=None, fast=False, sigma=0.01):
    dev = _util.device(device)
    size, n_vis = (64, 5_000) if fast else (128, 20_000)
    x = torch.from_numpy(shepp_logan(size))[None, None]
    physics = RadioInterferometry((size, size), uv_coverage(n_vis),
                                  noise_model=GaussianNoise(sigma, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    tv = TVDenoiser(20)
    psnr = PSNR()
    with torch.no_grad():
        # scale the step to the operator norm (power method, one-time)
        nrm = float(physics.compute_norm(x, max_iter=20))
        model = optim_builder("FISTA", data_fidelity=L2(),
                              prior=PnP(lambda u, s: tv(u.real, 0.002)),
                              params_algo={"stepsize": 1.0 / nrm, "g_param": 0.05},
                              max_iter=_util.scale(40, 10, fast),
                              custom_init=lambda yv, p: p.A_adjoint(yv).real / nrm, device=dev)
        xhat = model(y, physics)
        dirty = physics.A_adjoint(y).real / nrm
    out = {"norm": nrm, "psnr_dirty": float(psnr(dirty, x).mean()),
           "psnr_xhat": float(psnr(xhat.real, x).mean()), "x_hat": {"pnp_fista": xhat}}
    print(f"dirty image PSNR: {out['psnr_dirty']:.2f} dB -> PnP-FISTA: {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Diffusion posterior samplers with a training-free denoiser (port of
examples/demo_diffusion_sampling.py): DDRM (50 levels) and DiffPIR (30
steps) with a db4 wavelet denoiser, on 64x64 inpainting (half the pixels,
noise 0.05), against the adjoint; and DPS (200 steps, guidance 3) with the
analytic denoiser of a Gaussian prior, whose sample's mean sits near the
prior's.
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import WaveletDenoiser
from ..optim import L2
from ..physics import GaussianNoise, Inpainting
from ..sampling import DDRM, DPS, DiffPIR
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=1))[None]
    physics = Inpainting((1, 64, 64), mask=0.5, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.05, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    psnr = PSNR()
    p = lambda v: float(psnr(v, x).mean())
    gen = lambda s: torch.Generator(dev).manual_seed(s)
    out = {"psnr_adjoint": p(physics.A_adjoint(y))}
    print(f"adjoint baseline: {out['psnr_adjoint']:.2f} dB")
    den = WaveletDenoiser("db4", 3)
    with torch.no_grad():
        ddrm = DDRM(denoiser=lambda u, s: den(u, 0.7 * s), sigmas=np.linspace(1, 0, _util.scale(50, 12, fast)))
        out["psnr_ddrm"] = p(ddrm(y, physics, generator=gen(2)))
        print(f"DDRM   : {out['psnr_ddrm']:.2f} dB")
        diffpir = DiffPIR(lambda u, s: den(u, 0.7 * s), data_fidelity=L2(), max_iter=_util.scale(30, 10, fast),
                          zeta=1.0, sigma=0.05)
        out["psnr_diffpir"] = p(diffpir(y, physics, generator=gen(3)))
        print(f"DiffPIR: {out['psnr_diffpir']:.2f} dB")
    # DPS guides the reverse diffusion by autograd through the denoiser, a
    # score-model-like one (D ~ E[x0 | x_t]): with the analytic denoiser of a
    # Gaussian prior the sample concentrates near the posterior mean
    mu, tau = float(x.mean()), 0.4

    def gauss_den(u, s, **kwargs):
        s2 = torch.as_tensor(s, dtype=u.dtype, device=u.device) ** 2
        return (mu * s2 + u * tau ** 2) / (tau ** 2 + s2)

    dps = DPS(gauss_den, data_fidelity=L2(),
              max_iter=_util.scale(200, 50, fast), guidance_scale=3.0)
    xd = dps(y, physics, generator=gen(4))
    out.update(psnr_dps=p(xd), dps_sample_mean=float(xd.mean()), prior_mean=mu)
    print(f"DPS (Gaussian-prior score): {out['psnr_dps']:.2f} dB "
          f"(sample mean {out['dps_sample_mean']:.2f}, prior mean {mu:.2f})")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

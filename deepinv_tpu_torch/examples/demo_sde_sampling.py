"""Score-based SDE samplers (port of examples/demo_sde_sampling.py): the
variance-exploding and variance-preserving reverse SDEs with Euler (200
steps), VE with Heun (40 steps) and flow matching (50 steps), driven by the
analytic denoiser of a Gaussian image prior N(0.5, 0.2^2); each sample's
mean reaches the prior's 0.5.
"""

import numpy as np
import torch

from ..sampling import (EulerSolver, FlowMatching, HeunSolver, VarianceExplodingDiffusion,
                        VariancePreservingDiffusion)
from . import _util


class ShrinkDenoiser(torch.nn.Module):
    """The analytic MMSE denoiser of the Gaussian prior N(mu, tau^2)."""

    mu, tau = 0.5, 0.2

    def forward(self, x, sigma, **kwargs):
        s2 = torch.as_tensor(sigma, dtype=x.dtype, device=x.device) ** 2
        return (self.mu * s2 + x * self.tau ** 2) / (self.tau ** 2 + s2)


def main(device=None, fast=False):
    dev = _util.device(device)
    den = ShrinkDenoiser()
    shape = (4, 1, 16, 16)
    gen = lambda s: torch.Generator(dev).manual_seed(s)
    out = {}
    ts = np.linspace(1.0, 1e-3, _util.scale(200, 50, fast))
    for name, sde in [("ve", VarianceExplodingDiffusion(den, sigma_min=0.01, sigma_max=5.0)),
                      ("vp", VariancePreservingDiffusion(den))]:
        x0 = sde.prior_sample(shape, generator=gen(0), device=dev)
        x = EulerSolver(ts).sample(sde, x0, generator=gen(1))
        out[f"{name}_euler_mean"] = float(x.mean())
        print(f"{name.upper()} + Euler({len(ts)}): sample mean = {float(x.mean()):.3f} "
              f"(target 0.5)")
    # Heun (second order) gets there in far fewer steps
    sde = VarianceExplodingDiffusion(den, sigma_min=0.01, sigma_max=5.0)
    x0 = sde.prior_sample(shape, generator=gen(2), device=dev)
    x_heun = HeunSolver(np.linspace(1.0, 1e-3, 40)).sample(sde, x0, generator=gen(3))
    out["ve_heun_mean"] = float(x_heun.mean())
    print(f"VE + Heun(40): sample mean = {out['ve_heun_mean']:.3f}")
    fm = FlowMatching(den, timesteps=np.linspace(1.0, 0.0, 50))
    x_fm = fm.sample(torch.randn(shape, generator=gen(4), device=dev), generator=gen(5))
    out["flow_matching_mean"] = float(x_fm.mean())
    print(f"FlowMatching(50): sample mean = {out['flow_matching_mean']:.3f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

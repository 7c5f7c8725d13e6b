"""Langevin samplers against an analytic posterior (port of
examples/demo_mcmc_sampling.py): ULA (3000 steps) and SKRock (1500 steps
of 5 stages) over the exact score of a Gaussian prior N(0.3, 0.5^2), for
denoising a constant 16x16 image at noise 0.3; each chain's mean lies
within 0.2 of the conjugate posterior's mean.
"""

import torch

from ..optim import L2, ScorePrior
from ..physics import Denoising, GaussianNoise
from ..sampling import ULA, SKRock
from . import _util


class GaussScoreDenoiser(torch.nn.Module):
    """The denoiser of the prior N(mu, tau^2), which gives exact scores."""

    mu, tau = 0.3, 0.5

    def forward(self, x, sigma, **kwargs):
        s2 = torch.as_tensor(sigma, dtype=x.dtype, device=x.device) ** 2
        return (self.mu * s2 + x * self.tau ** 2) / (self.tau ** 2 + s2)


def main(device=None, fast=False):
    dev = _util.device(device)
    sigma_noise = 0.3
    physics = Denoising(noise_model=GaussianNoise(sigma_noise, device="cpu"))
    x = torch.full((1, 1, 16, 16), 0.7)
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    prior = ScorePrior(GaussScoreDenoiser())
    # the analytic posterior mean of the conjugate Gaussian pair
    mu, tau = GaussScoreDenoiser.mu, GaussScoreDenoiser.tau
    post_mean = (mu / tau ** 2 + y / sigma_noise ** 2) / (1 / tau ** 2 + 1 / sigma_noise ** 2)
    out = {}
    for name, sampler in [
            ("ula", ULA(prior, L2(sigma=sigma_noise), step_size=0.01, sigma=1e-3,
                        max_iter=_util.scale(3000, 600, fast), burnin_ratio=0.3, clip=None)),
            ("skrock", SKRock(prior, L2(sigma=sigma_noise), step_size=2e-3, sigma=1e-3,
                              max_iter=_util.scale(1500, 300, fast), inner_iter=5,
                              burnin_ratio=0.3, clip=None))]:
        with torch.no_grad():
            mean, var = sampler.sample(y, physics, generator=torch.Generator(dev).manual_seed(1))
        out[f"{name}_mean_error"] = float((mean - post_mean).abs().max())
        out[f"{name}_std"] = float(var.sqrt().mean())
        print(f"{name}: max |mean - analytic posterior mean| = {out[f'{name}_mean_error']:.3f}, "
              f"mean posterior std = {out[f'{name}_std']:.3f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Stein's unbiased risk estimate (port of examples/demo_sure_denoising.py):
eight 32x32 images under Gaussian noise of 0.1, denoised by a 3x3 median
filter; SURE estimates each image's mean squared error from the noisy
image alone, and its mean lies within 0.01 of the true MSE's (the JAX demo
asserts it). The Poisson variant (gain 0.1) gives its own estimate.
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import SureGaussianLoss, SurePoissonLoss
from ..models import MedianFilter
from ..physics import Denoising, GaussianNoise, PoissonNoise
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    sigma = 0.1
    x = torch.from_numpy(np.stack([random_circles(32, seed=i) for i in range(8)]))
    physics = Denoising(noise_model=GaussianNoise(sigma, device="cpu"))
    y = physics(x, generator=_util.generator(0))
    # the Hutchinson probe of the divergence, drawn with the data
    probe = torch.randn(y.shape, generator=_util.generator(1))
    x, y, probe, physics = x.to(dev), y.to(dev), probe.to(dev), physics.to(dev)

    den = MedianFilter(kernel_size=3)
    model = lambda yv, p, **kw: den(yv, sigma)
    x_net = model(y, physics)
    sure = SureGaussianLoss(sigma=sigma)(x_net=x_net, y=y, physics=physics, model=model,
                                         probe=probe)
    true_mse = ((x_net - x) ** 2).reshape(x.shape[0], -1).mean(1)
    print("SURE estimate:", np.round(sure.cpu().numpy(), 4))
    print("true MSE     :", np.round(true_mse.cpu().numpy(), 4))
    out = {"sure": [float(v) for v in sure], "true_mse": [float(v) for v in true_mse],
           "sure_mean": float(sure.mean()), "true_mse_mean": float(true_mse.mean())}

    # the Poisson variant
    gain = 0.1
    pphysics = Denoising(noise_model=PoissonNoise(gain=gain, device="cpu"))
    yp = pphysics(x.cpu(), generator=_util.generator(2))
    sign = (torch.rand(yp.shape, generator=_util.generator(3)) < 0.5).float() * 2 - 1
    yp, sign, pphysics = yp.to(dev), sign.to(dev), pphysics.to(dev)
    sure_p = SurePoissonLoss(gain=gain)(x_net=model(yp, pphysics), y=yp, physics=pphysics,
                                        model=model, probe=sign)
    out["sure_poisson_mean"] = float(sure_p.mean())
    print("Poisson SURE estimate:", out["sure_poisson_mean"])
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""UNSURE: SURE with a learned noise level (port of examples/demo_unsure.py):
four 32x32 images under Gaussian noise of 0.1, a DnCNN of depth 3 and the
noise level started at half the truth (0.05). Each of 40 steps first calls
``SureGaussianLoss(unsure=True)`` eagerly, which moves ``sigma2`` by one
step of gradient ascent on the divergence, and then takes one Adam step of
the network (lr 1e-3, optax's defaults) on SURE with that level frozen, the
same probe in both. The level sweeps toward the truth: its closest visit
lies nearer 0.1 than its start (the JAX demo asserts it).
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import PSNR, SureGaussianLoss
from ..models import DnCNN
from ..physics import Denoising, GaussianNoise
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    steps = _util.scale(40, 20, fast)
    sigma_true = 0.1
    x = torch.from_numpy(np.stack([random_circles(32, seed=s) for s in range(4)]))
    physics = Denoising(noise_model=GaussianNoise(sigma_true, device="cpu"))
    y = physics(x, generator=_util.generator(0))
    x, y, physics = x.to(dev), y.to(dev), physics.to(dev)

    # a deliberately wrong initial noise level (half the truth)
    loss = SureGaussianLoss(sigma=0.5 * sigma_true, unsure=True, step_size=1e-3)
    net = DnCNN(1, 1, depth=3, nf=8, generator=_util.generator(1), device=dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    model = lambda u, p, **kw: net(u, 0.1)
    probes = _util.generator(10)
    sigmas = []
    for _ in range(steps):
        probe = torch.randn(y.shape, generator=probes).to(dev)
        # the eager UNSURE call moves loss.sigma2 (outside the graph)
        with torch.no_grad():
            loss(y=y, physics=physics, model=model, probe=probe)
        # the network's step on SURE at the current level, frozen
        frozen = SureGaussianLoss(sigma=float(np.sqrt(loss.sigma2)))
        l = frozen(y=y, physics=physics, model=model, probe=probe).mean()
        opt.zero_grad(set_to_none=True)
        l.backward()
        opt.step()
        sigmas.append(float(np.sqrt(loss.sigma2)))

    closest = min(sigmas, key=lambda s: abs(s - sigma_true))
    print(f"sigma trajectory: {sigmas[0]:.4f} -> {sigmas[-1]:.4f} (true {sigma_true}; closest "
          f"visit {closest:.4f})")
    psnr = PSNR(max_pixel=1.0)
    with torch.no_grad():
        p_in, p_out = float(psnr(y, x).mean()), float(psnr(net(y, 0.1), x).mean())
    print(f"PSNR: noisy {p_in:.2f} dB -> {p_out:.2f} dB after {steps} joint steps")
    return {"sigmas": sigmas, "sigma_closest": closest, "sigma_true": sigma_true,
            "psnr_y": p_in, "psnr_xhat": p_out}


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Constrained inpainting by an unfolded Chambolle-Pock (port of
examples/demo_unfolded_constrained_lista.py): 8 CP iterations with the
explicit splitting ``K = A``, the data term the indicator of the l2 ball of
radius ``sigma sqrt(m)`` about ``y`` (a closed-form projection in the
measurement space) and a db4 wavelet prior, the stepsizes and thresholds
trained for 60 Adam steps on 8 shifted 64x64 phantoms (half the pixels,
noise 0.05); the reconstruction beats the zero fill.
"""

import math

import numpy as np
import torch

from ..datasets.phantoms import shepp_logan
from ..optim import IndicatorL2, WaveletPrior
from ..physics import Denoising, GaussianNoise, Inpainting
from ..unfolded import unfolded_builder
from . import _util


def main(device=None, fast=False, steps=None):
    dev = _util.device(device)
    steps = _util.scale(60, 6, fast) if steps is None else steps
    H = 32 if fast else 64
    sigma = 0.05
    # ground truths: shifted phantoms (a stand-in for a dataset)
    base = torch.from_numpy(shepp_logan(H))[None, None]
    rng = np.random.default_rng(0)
    xs = torch.cat([torch.roll(base, (int(a), int(b)), (-2, -1))
                    for a, b in rng.integers(-4, 5, (8, 2))])
    physics = Inpainting((1, H, H), mask=0.5, generator=_util.generator(1),
                         noise_model=GaussianNoise(sigma, device="cpu"), device="cpu")
    ys = physics(xs, generator=_util.generator(2))
    physics, xs, ys = physics.to(dev), xs.to(dev), ys.to(dev)
    # the radius of the feasibility ball: E||noise|| on the kept pixels
    radius = sigma * math.sqrt(float(physics.mask.sum()))

    # with K = A the indicator's prox is a projection onto a ball in the
    # measurement space: exact and differentiable, so the whole network trains
    model = unfolded_builder("CP", data_fidelity=IndicatorL2(radius=radius),
                             prior=WaveletPrior(wv="db4", level=2),
                             params_algo={"stepsize": 1.0, "stepsize_dual": 1.0,
                                          "g_param": 0.01, "lambda": 1.0},
                             max_iter=8,
                             trainable_params=["stepsize", "stepsize_dual", "g_param"],
                             K=physics.A, K_adjoint=physics.A_adjoint, device=dev)
    ident = Denoising()  # with an explicit K, the model sees the identity
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    psnr = lambda a, b: float(10 * torch.log10(1.0 / ((a - b) ** 2).mean()))
    x0 = physics.A_adjoint(ys)
    out = {"psnr_zero_fill": psnr(x0, xs)}
    print(f"zero-fill PSNR {out['psnr_zero_fill']:.2f} dB")
    for it in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((model(ys, ident) - xs) ** 2).mean()
        loss.backward()
        opt.step()
        if it % max(steps // 5, 1) == 0:
            print(f"step {it:3d}  train mse {float(loss.detach()):.5f}")
    with torch.no_grad():
        xhat = model(ys, ident)
        res = ((physics.A(xhat) - ys) ** 2).sum((1, 2, 3)).sqrt()
    out.update(psnr_xhat=psnr(xhat, xs), max_residual=float(res.max()), radius=radius)
    print(f"unfolded constrained-CP PSNR {out['psnr_xhat']:.2f} dB")
    print(f"max residual {out['max_residual']:.4f} (ball radius {radius:.4f})")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

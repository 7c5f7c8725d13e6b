"""Scan-specific self-supervised MRI (port of examples/demo_scan_specific.py):
four 64x64 complex images under 4x Gaussian-density column undersampling.
First the bias of plain splitting, isolated: a one-parameter reconstructor
``a * A^T y`` trained for 300 Adam steps (lr 5e-2) under plain SSDU (split
ratio 0.6) and under the K-weighted splitting loss, whose k-space weight
(``(1 - K)^{-1/2}`` from the two generators' sampling densities, 2000 draws
each) ranges over [1.00, 5.76] in the JAX demo. Then the pipeline: the
K-weighted loss adapts a MoDL (3 unrolled steps of a DnCNN(2, 2) of depth
5) and fine-tunes it for 60 steps (lr 1e-4), its loss falling.
"""

import numpy as np
import torch
from torch import nn

from ..datasets import random_circles
from ..loss import PSNR, SplittingLoss, WeightedSplittingLoss
from ..models import DnCNN, MoDL
from ..physics import MRI
from ..physics.generator import BernoulliSplittingMaskGenerator, GaussianMaskGenerator
from . import _util


class ScaledZeroFill(nn.Module):
    """A one-parameter reconstructor ``a * A^T y``: the cleanest probe of
    a loss's bias."""

    def __init__(self, device=None):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(1.0, device=device))

    def forward(self, y, physics, **kwargs):
        return self.a * physics.A_adjoint(y)


def train(loss, model, y, physics, steps, lr=5e-2, seed=3):
    """``steps`` Adam steps (optax's defaults) of ``model`` under ``loss``,
    the splits drawn from a generator seeded ``seed``: the losses, one a
    step, each before its step."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    splits = _util.generator(seed)
    losses = []
    for _ in range(steps):
        v = loss(y=y, physics=physics, model=model, generator=splits).mean()
        opt.zero_grad(set_to_none=True)
        v.backward()
        opt.step()
        losses.append(float(v.detach()))
    return losses


def main(device=None, fast=False):
    dev = _util.device(device)
    steps = _util.scale(300, 20, fast)
    finetune_steps = _util.scale(60, 10, fast)
    H = W = 64
    x = torch.cat([torch.from_numpy(np.stack([random_circles(W, seed=i) for i in range(4)])),
                   torch.zeros(4, 1, H, W)], dim=1)  # (B, 2, H, W) real/imag

    # the scan protocol: Gaussian-density 4x column undersampling
    physics_generator = GaussianMaskGenerator((2, H, W), acceleration=4, device="cpu")
    mask = physics_generator.step(1, generator=_util.generator(0))["mask"][0]
    physics = MRI(mask=mask.to(dev), img_size=(H, W), device=dev)
    x = x.to(dev)
    y = physics(x)
    zf = float(PSNR(complex_abs=True)(physics.A_adjoint(y), x).mean())

    split_gen = BernoulliSplittingMaskGenerator((2, H, W), split_ratio=0.6, device="cpu")
    wloss = WeightedSplittingLoss(mask_generator=split_gen, physics_generator=physics_generator)
    out = {"k_weight_min": float(wloss.weight.min()), "k_weight_max": float(wloss.weight.max()),
           "psnr_zero_filled": zf, "scale": {}}
    print(f"K-weight range: [{out['k_weight_min']:.2f}, {out['k_weight_max']:.2f}]  "
          f"(1 = unweighted)")

    # the bias, isolated: a single scale a trained on each objective
    for name, loss in [("plain", SplittingLoss(split_ratio=0.6, eval_split_input=False)),
                       ("K-weighted", wloss)]:
        m = loss.adapt_model(ScaledZeroFill(device=dev))
        train(loss, m, y, physics, steps)
        out["scale"][name] = float(m.model.a.detach())
        print(f"{name}: learned scale a = {out['scale'][name]:.3f} (unbiased = 1; plain "
              f"overshoots by ~1/split_ratio)")

    # the pipeline: adapt_model wraps any reconstructor so that it trains on
    # split inputs and evaluates on the whole measurement; from a random
    # start the objective falls but the true PSNR does not beat the zero fill
    model = wloss.adapt_model(MoDL(DnCNN(2, 2, depth=5, nf=16, generator=_util.generator(0),
                                         device=dev), num_iter=3, device=dev))
    first = train(wloss, model, y, physics, 1, lr=1e-4, seed=2)
    losses = train(wloss, model, y, physics, finetune_steps, lr=1e-4, seed=4)
    out["finetune_losses"] = first + losses
    print(f"weighted-SSDU MoDL fine-tune: loss {first[0]:.5f} -> {losses[-1]:.5f} over "
          f"{finetune_steps} steps (zero-filled baseline {zf:.2f} dB)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

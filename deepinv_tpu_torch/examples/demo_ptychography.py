"""Ptychography (port of examples/demo_ptychography.py): a 32x32 complex
object (a phantom amplitude, a smooth phase) scanned on a 6-pixel grid so
that every pixel is lit by several probes, recovered by 1500 gradient steps
of 0.03 on the amplitude loss from a flat start; after the global phase is
corrected, the relative error is below 1e-2.
"""

import math

import numpy as np
import torch

from ..datasets import random_circles
from ..optim import AmplitudeLoss
from ..physics import Ptychography
from ..physics.phase_retrieval import correct_global_phase, cosine_similarity
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    H = W = 32
    amp = 0.5 + 0.5 * torch.from_numpy(random_circles(H, seed=7)).reshape(1, 1, H, W)
    ii, jj = torch.meshgrid(torch.linspace(-1, 1, H), torch.linspace(-1, 1, W), indexing="ij")
    phase = 0.3 * torch.sin(2 * math.pi * ii) * torch.cos(2 * math.pi * jj)
    x = (amp * torch.exp(1j * phase)).to(torch.complex64).to(dev)
    # a 6x6 scan grid: the default centre-only raster leaves the border dark
    shifts = np.array([(r, c) for r in range(0, H, 6) for c in range(0, W, 6)])
    physics = Ptychography((1, H, W), shifts=shifts, device=dev)
    y = physics(x)
    print(f"scans: {y.shape[1]}, measurement {tuple(y.shape)}")
    fid = AmplitudeLoss()
    xk = torch.full_like(x, 0.5 + 0j)
    steps = _util.scale(1500, 1500, fast)
    with torch.no_grad():
        for _ in range(steps):
            xk = xk - 0.03 * fid.grad(xk, y, physics)
    x_hat = correct_global_phase(xk, x)
    out = {"rel_error": float((x_hat - x).norm() / x.norm()),
           "cosine": float(cosine_similarity(x_hat, x).abs())}
    print(f"relative error after {steps} GD steps: {out['rel_error']:.2e} "
          f"(cosine similarity {out['cosine']:.5f})")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

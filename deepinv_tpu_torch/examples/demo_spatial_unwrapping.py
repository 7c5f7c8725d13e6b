"""Spatial phase unwrapping (port of examples/demo_spatial_unwrapping.py):
a 64x64 ramp and bump of about six thresholds wrapped modulo 2 pi (over 20%
of the pixels wrap), unwrapped by Itoh's method within 1e-4 of the truth up
to a global multiple of 2 pi, and within 0.1 (relative L2) under noise
0.01.
"""

import math

import torch

from ..physics import GaussianNoise, SpatialUnwrapping
from . import _util


def unwrap_error(x_hat, x):
    """``x_hat - x`` less the global multiple of 2 pi it is recovered up to."""
    return x_hat - x - torch.round((x_hat - x).mean() / (2 * math.pi)) * 2 * math.pi


def main(device=None, fast=False):
    dev = _util.device(device)
    H = W = 64
    ii, jj = torch.meshgrid(torch.linspace(-1, 1, H), torch.linspace(-1, 1, W), indexing="ij")
    # a smooth ramp and bump: a range of ~6 thresholds, gradients below pi
    x = (8.0 * ii + 10.0 * torch.exp(-4 * (ii ** 2 + jj ** 2)))[None, None].to(dev)
    physics = SpatialUnwrapping(threshold=2 * math.pi, mode="round")
    with torch.no_grad():
        y = physics.A(x)
        out = {"wrapped_share": float(((x - y).abs() > 1e-6).float().mean())}
        print(f"wrapped pixels: {100 * out['wrapped_share']:.1f}% of the image")
        # Itoh: integrate the wrapped finite differences
        out["max_error"] = float(unwrap_error(physics.A_dagger(y), x).abs().max())
        print(f"Itoh unwrapping max error: {out['max_error']:.2e}")
        # with noise, the unwrap is approximate but close
        yn = GaussianNoise(0.01, device="cpu")(y.cpu(), generator=_util.generator(0)).to(dev)
        out["noisy_rel_error"] = float(unwrap_error(physics.A_dagger(yn), x).norm() / x.norm())
    print(f"noisy unwrap relative error: {out['noisy_rel_error']:.3f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

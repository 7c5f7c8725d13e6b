"""Single-photon lidar (port of examples/demo_lidar.py): a 32x32 scene of
depths 10-30 bins and reflectivities of 100-140 photons a pixel over a
background of 1, seen as 40-bin Poisson histograms of a pulse of width 1.5.
The matched-filter inversion recovers the depth within 1.5 bins (mean
absolute error) and the reflectivity within 0.3 (relative mean error).
"""

import torch

from ..datasets import random_circles
from ..physics import PoissonNoise, SinglePhotonLidar
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    H = W = 32
    depth = 10.0 + 20.0 * torch.from_numpy(random_circles(H, seed=5)).reshape(1, 1, H, W)
    refl = 100.0 + 40.0 * torch.from_numpy(random_circles(H, seed=6)).reshape(1, 1, H, W)
    x = torch.cat([depth, refl, torch.ones_like(depth)], dim=1)  # (1, 3, H, W)
    physics = SinglePhotonLidar(sigma=1.5, bins=40,
                                noise_model=PoissonNoise(gain=1.0, device="cpu"))
    y = physics(x, generator=_util.generator(0))  # (1, T, H, W) photon counts
    physics, y, depth, refl = physics.to(dev), y.to(dev), depth.to(dev), refl.to(dev)
    print(f"histograms: {tuple(y.shape)}, total photons {float(y.sum()):.0f}")
    with torch.no_grad():
        # the matched filter: log-matched filtering and moment matching
        x_hat = physics.A_dagger(y)
    out = {"depth_mae": float((x_hat[:, 0] - depth[:, 0]).abs().mean()),
           "reflectivity_rel_error": float((x_hat[:, 1] - refl[:, 0]).abs().mean() / refl.mean())}
    print(f"depth MAE: {out['depth_mae']:.3f} bins (pulse sigma 1.5)")
    print(f"reflectivity rel. error: {out['reflectivity_rel_error']:.3f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

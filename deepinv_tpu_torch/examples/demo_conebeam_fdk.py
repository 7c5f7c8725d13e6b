"""Cone-beam CT and the FDK (port of examples/demo_conebeam_fdk.py): a
32³ volume of ellipsoids (8³ in the fast mode) seen over 360 degrees at 90
angles (12) by a 48x64 flat detector (12x16), noise 0.01 on the normalised
radiographs. It reconstructs by the FDK (cosine-weighted filtered
backprojection) and by CG on the normal equations.
"""

import numpy as np
import torch

from ..loss.metric import PSNR
from ..physics import GaussianNoise, TomographyWithAstra
from . import _util


def ellipsoids(n: int) -> np.ndarray:
    """A Shepp-Logan-like volume of four ellipsoids, ``(n, n, n)`` float32."""
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    return (1.0 * ((xx / 0.7) ** 2 + (yy / 0.9) ** 2 + (zz / 0.8) ** 2 < 1)
            - 0.5 * ((xx / 0.55) ** 2 + (yy / 0.75) ** 2 + (zz / 0.65) ** 2 < 1)
            + 0.4 * (((xx - 0.2) / 0.15) ** 2 + (yy / 0.2) ** 2 + (zz / 0.3) ** 2 < 1)
            + 0.4 * (((xx + 0.2) / 0.15) ** 2 + (yy / 0.25) ** 2 + (zz / 0.3) ** 2 < 1)
            ).astype(np.float32)


def main(device=None, fast=False):
    dev = _util.device(device)
    n = 8 if fast else 32
    x = torch.from_numpy(ellipsoids(n))[None, None]
    physics = TomographyWithAstra(
        (n, n, n), angles=_util.scale(90, 12, fast), angular_range=(0, 360),
        geometry_type="conebeam",
        geometry_parameters={"source_radius": 90.0, "detector_radius": 30.0},
        n_detector_pixels=(12, 16) if fast else (48, 64), detector_spacing=(1.5, 1.5),
        normalize=True, noise_model=GaussianNoise(0.01, device=dev), device=dev)
    x = x.to(dev)
    psnr = PSNR()
    with torch.no_grad():
        clean = physics.A(x)
        # the noise drawn on the CPU (the draws are host arrays), so that the
        # card and the CPU draw alike
        y = physics.noise_model(clean, draws=[
            torch.randn(clean.shape, generator=_util.generator(0))])
        print(f"radiographs: {tuple(y.shape)} (B, C, det-rows, angles, det-cols)")
        out = {"psnr_fdk": float(psnr(physics.A_dagger(y, fbp=True), x)[0]),
               "psnr_cg": float(psnr(physics.A_dagger(y), x)[0]),
               "psnr_zero": float(psnr(torch.zeros_like(x), x)[0])}
    print(f"FDK PSNR      : {out['psnr_fdk']:.2f}")
    print(f"CG-dagger PSNR: {out['psnr_cg']:.2f} (the zero volume: {out['psnr_zero']:.2f})")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

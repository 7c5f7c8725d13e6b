"""Blind denoising (port of examples/demo_blind_denoising.py): two 64x64
images under Gaussian noise of 0.12; the wavelet-MAD and the
patch-covariance estimators each find the level within 35%, and the
wavelet estimate drives a wavelet denoiser that gains over 2 dB.
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import PatchCovarianceNoiseEstimator, WaveletDenoiser, WaveletNoiseEstimator
from . import _util

SIGMA = 0.12


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(np.stack([random_circles(64, seed=s) for s in (1, 2)]))
    y = (x + SIGMA * torch.randn(x.shape, generator=_util.generator(0))).to(dev)
    x = x.to(dev)
    out = {"rel_error": {}}
    with torch.no_grad():
        for name, estimator in [("wavelet-MAD", WaveletNoiseEstimator()),
                                ("patch-covariance", PatchCovarianceNoiseEstimator())]:
            sigma_hat = estimator(y)
            out["rel_error"][name] = float((sigma_hat - SIGMA).abs().max()) / SIGMA
            print(f"{name:18s} sigma_hat = {sigma_hat.cpu().numpy().round(4)} (true {SIGMA}, "
                  f"rel err {out['rel_error'][name]:.1%})")
        # the blind pipeline: the estimated level drives the denoiser's strength
        sigma_hat = WaveletNoiseEstimator()(y)
        xhat = WaveletDenoiser(level=3)(y, 3.0 * sigma_hat.mean())
    psnr = PSNR(max_pixel=1.0)
    out["psnr_y"], out["psnr_xhat"] = float(psnr(y, x).mean()), float(psnr(xhat, x).mean())
    print(f"PSNR: noisy {out['psnr_y']:.2f} dB -> blind-denoised {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

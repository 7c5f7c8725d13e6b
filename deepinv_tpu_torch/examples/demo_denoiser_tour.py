"""A tour of the training-free denoisers (port of
examples/demo_denoiser_tour.py): every denoiser shares ``denoiser(y,
sigma)``, so any of them fits in PnP, RED, diffusion sampling or an
unfolded network. On a 64x64 image at noise 25/255: the median, bilateral,
TV (200 Chambolle steps, the kernel on the card), TGV, db8 wavelets, a
wavelet dictionary, BM3D, and EPLL with a GMM fitted here on clean images,
each timed (to the device's finish). The TV output is returned under
``x_hat``.
"""

import time

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import (BM3D, BilateralFilter, EPLLDenoiser, MedianFilter, TGVDenoiser,
                      TVDenoiser, WaveletDenoiser, WaveletDictDenoiser)
from ..optim import GaussianMixtureModel
from ..optim.patch_prior import patch_extractor
from . import _util

SIGMA = 25 / 255


def fitted_epll(dev, patch: int = 6, components: int = 8, max_iters: int = 40):
    """EPLL with a patch GMM fitted on clean synthetic images (upstream
    downloads a pretrained GMM instead)."""
    imgs = torch.from_numpy(np.stack([random_circles(64, seed=50 + i) for i in range(10)]))
    patches, _ = patch_extractor(imgs.to(dev), patch)
    flat = patches.reshape(-1, patch * patch)[:6000]
    # EM starts from the means at ``components`` distinct patches, drawn on the
    # CPU so that the card and the CPU start alike
    start = torch.randperm(flat.shape[0], generator=_util.generator(1))[:components]
    gmm = GaussianMixtureModel(components, patch * patch, device=dev).fit(
        flat, max_iters=max_iters, draws=[start])
    return EPLLDenoiser(gmm=gmm, patch_size=patch, device=dev)


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=7))[None]
    noisy = (x + SIGMA * torch.randn(x.shape, generator=_util.generator(0))).to(dev)
    x = x.to(dev)
    psnr = PSNR()
    denoisers = [("MedianFilter", MedianFilter(kernel_size=3)),
                 ("BilateralFilter", BilateralFilter(sigma_space=2.0, sigma_color=0.2)),
                 ("TV", TVDenoiser()),
                 ("TGV", TGVDenoiser()),
                 ("Wavelet (db8)", WaveletDenoiser("db8", level=3)),
                 ("WaveletDict", WaveletDictDenoiser(("db2", "db4", "db8"), level=3)),
                 ("BM3D", BM3D()),
                 ("EPLL (fitted GMM)", fitted_epll(dev, max_iters=_util.scale(40, 10, fast)))]
    out = {"psnr_y": float(psnr(noisy, x)[0]), "psnr": {}, "seconds": {}}
    print(f"noisy input: {out['psnr_y']:.2f} dB (sigma=25/255)\n")
    print(f"{'denoiser':>17s}  {'PSNR':>6s}  {'time':>7s}")
    with torch.no_grad():
        for name, den in denoisers:
            t0 = time.perf_counter()
            den_out = den(noisy, SIGMA)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out["seconds"][name] = time.perf_counter() - t0
            out["psnr"][name] = float(psnr(den_out, x)[0])
            if name == "TV":
                out["x_hat"] = {"tv": den_out}
            print(f"{name:>17s}  {out['psnr'][name]:6.2f}  {out['seconds'][name]:6.2f}s")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

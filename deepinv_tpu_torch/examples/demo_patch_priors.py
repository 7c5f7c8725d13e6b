"""EPLL denoising with a patch GMM (port of examples/demo_patch_priors.py):
an 8-component Gaussian mixture over 6x6 patches of 12 clean 64x64 images,
fitted by 40 EM iterations on 6000 patches, then EPLL denoises an unseen
image at noise 0.1.
"""

import numpy as np
import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..optim import EPLL, GaussianMixtureModel
from ..optim.patch_prior import patch_extractor
from . import _util


def main(device=None, fast=False, size=None, patch=6, components=8, sigma=0.1):
    dev = _util.device(device)
    size = (32 if fast else 64) if size is None else size
    # the training set: clean synthetic images -> patch GMM by EM
    imgs = torch.from_numpy(np.stack([random_circles(size, seed=i) for i in range(12)])).to(dev)
    patches, _ = patch_extractor(imgs, patch)
    flat = patches.reshape(-1, patch * patch)[:6000]
    # EM starts from the means at ``components`` distinct patches, drawn on the
    # CPU so that the card and the CPU start alike
    start = torch.randperm(flat.shape[0], generator=_util.generator(1))[:components]
    gmm = GaussianMixtureModel(components, patch * patch, device=dev).fit(
        flat, max_iters=_util.scale(40, 10, fast), draws=[start])
    epll = EPLL(gmm=gmm, patch_size=patch, device=dev)

    x = torch.from_numpy(random_circles(size, seed=100))[None]
    y = x + sigma * torch.randn(x.shape, generator=_util.generator(0))
    x, y = x.to(dev), y.to(dev)
    with torch.no_grad():
        xhat = epll.denoise(y, sigma)
    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x).mean()), "psnr_xhat": float(psnr(xhat, x).mean())}
    print(f"EPLL denoising: noisy {out['psnr_y']:.2f} dB -> {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

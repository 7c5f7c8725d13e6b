"""Fitting NIQE to one's own pristine images (port of
examples/demo_custom_niqe.py): the pristine model (the multivariate Gaussian
of the 36 natural-scene features) fitted on 8 low-pass noise images of
96x96 in 16-pixel patches, saved to and read back from a local file, then
used to score a held-out image and its noisy (0.1), blurred and
median-denoised versions: the clean image scores below the noisy one.
"""

import os
import tempfile

import numpy as np
import torch

from ..loss import NIQE, PSNR
from ..models import MedianFilter
from ..ops import gaussian_blur
from ..ops.conv import conv2d
from . import _util


def natural_image(seed: int, size: int = 96) -> np.ndarray:
    """Low-pass filtered noise in [0, 1], ``(1, size, size)``: a stand-in for
    a pristine photographic dataset."""
    r = np.random.default_rng(seed)
    f = np.fft.fft2(r.normal(size=(size, size)))
    k = np.hypot(np.fft.fftfreq(size)[:, None], np.fft.fftfreq(size)[None])
    img = np.real(np.fft.ifft2(f * np.exp(-(k ** 2) / (2 * 0.06 ** 2))))
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return img.astype(np.float32)[None]


def main(device=None, fast=False):
    dev = _util.device(device)
    # the pristine model: 8 distortion-free images, 16-pixel patches
    pristine = [torch.from_numpy(natural_image(100 + i)).to(dev) for i in range(8)]
    kw = dict(patch_size=16, patch_overlap=8, denominator=1 / 255.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "niqe_custom.npz")
        params = NIQE(**kw).create_weights(pristine, sharpness_threshold=0.5, save_path=path)
        print(f"fitted pristine MVG: mu {tuple(params['mu'].shape)}, "
              f"cov {tuple(params['cov'].shape)}")
        # the weights round-trip through a local file (no download)
        niqe = NIQE(weights_path=path, **kw)
    x = torch.from_numpy(natural_image(7))[None]
    noisy = (x + 0.10 * torch.randn(x.shape, generator=_util.generator(0))).clamp(0, 1)
    x, noisy = x.to(dev), noisy.to(dev)
    psnr = PSNR()
    out = {"niqe": {}, "psnr": {}}
    with torch.no_grad():
        images = [("clean", x), ("noisy", noisy),
                  ("blurry", conv2d(x, gaussian_blur(sigma=2.0).to(dev), padding="replicate")),
                  ("denoised", MedianFilter(kernel_size=3)(noisy, None))]
        print(f"{'image':>10s}  {'NIQE':>7s}  {'PSNR':>6s}")
        for name, im in images:
            out["niqe"][name], out["psnr"][name] = float(niqe(im)[0]), float(psnr(im, x)[0])
            print(f"{name:>10s}  {out['niqe'][name]:7.2f}  {out['psnr'][name]:6.2f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

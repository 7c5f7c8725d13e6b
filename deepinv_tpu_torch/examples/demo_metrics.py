"""The metrics (port of examples/demo_metrics.py) on a 64x64 phantom in
three channels under noise 0.1: the full-reference distortions, the
multispectral ones, the perceptual ones on the clipped image, LPIPS with
random features (no weights are fetched: the published metric needs a local
VGG-16 checkpoint, and random features still rank corruption, so mild noise
0.02 scores below heavy), the no-reference ones, and the pipeline features
(the magnitude PSNR of 2-channel complex data, a metric as a training loss,
a batch reduction).
"""

import torch

from ..datasets import shepp_logan
from ..loss.metric import ERGAS, MAE, MSE, NMSE, PSNR, SNR, SSIM, LpNorm, SpectralAngleMapper
from ..loss.perceptual import (GMSD, LPIPS, BlurStrength, CosineSimilarity, HaarPSI,
                               SharpnessIndex)
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(shepp_logan(64))[None, None]
    x3 = x.repeat(1, 3, 1, 1)
    noisy = x3 + 0.1 * torch.randn(x3.shape, generator=_util.generator(0))
    mild = x3 + 0.02 * torch.randn(x3.shape, generator=_util.generator(1))
    x, x3, noisy, mild = x.to(dev), x3.to(dev), noisy.to(dev), mild.to(dev)
    out = {}
    with torch.no_grad():
        for group, metrics, a in (
                ("full-reference distortion", (MSE(), NMSE(), MAE(), PSNR(), SNR(), SSIM(),
                                               LpNorm(p=2)), noisy),
                ("multispectral", (SpectralAngleMapper(), ERGAS(factor=4)), noisy),
                # HaarPSI takes inputs in [0, 1]
                ("perceptual", (GMSD(), HaarPSI(), CosineSimilarity()), noisy.clamp(0.0, 1.0))):
            print(f"== {group} ==")
            for m in metrics:
                out[type(m).__name__] = float(m(a, x3)[0])
                print(f"{type(m).__name__:22s} {out[type(m).__name__]:.4f}")
        # LPIPS on random features (pass vgg_pretrained= for the published metric)
        lp = LPIPS(allow_random_weights=True, generator=_util.generator(2), device=dev)
        out["LPIPS_mild"], out["LPIPS_heavy"] = float(lp(mild, x3)[0]), float(lp(noisy, x3)[0])
        print(f"{'LPIPS':22s} mild {out['LPIPS_mild']:.5f}  heavy {out['LPIPS_heavy']:.5f}")
        print("== no-reference ==")
        for m in (BlurStrength(), SharpnessIndex()):
            out[type(m).__name__] = float(m(x3)[0])
            print(f"{type(m).__name__:22s} {out[type(m).__name__]:.4f}")
        print("== pipeline features ==")
        # complex data: the magnitude PSNR of 2-channel MRI-style images
        z = torch.cat([x, torch.zeros_like(x)], dim=1)
        out["PSNR_complex_abs"] = float(PSNR(complex_abs=True)(z, z)[0])
        # a higher-is-better metric inverts itself as a training loss
        out["SSIM_train_loss"] = float(SSIM(train_loss=True)(noisy, x3)[0])
        out["PSNR_mean"] = float(PSNR(reduction="mean")(noisy, x3))
    for k in ("PSNR_complex_abs", "SSIM_train_loss", "PSNR_mean"):
        print(f"{k:22s} {out[k]:.4f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

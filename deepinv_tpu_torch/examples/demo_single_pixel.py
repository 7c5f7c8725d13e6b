"""The single-pixel camera (port of examples/demo_single_pixel.py): 4x
undersampled 32x32 Hadamard measurements under four orderings, each
reconstructed by the closed-form pseudo-inverse (cake-cutting and zig-zag
keep the smooth patterns first, sequency spreads over all frequencies);
then 30 PnP-HQS iterations with a db4 wavelet denoiser under noise 0.01
against the pseudo-inverse.
"""

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import WaveletDenoiser
from ..optim import L2, PnP, optim_builder
from ..physics import GaussianNoise, SinglePixelCamera
from . import _util

ORDERINGS = ("cake_cutting", "zig_zag", "xy", "sequency")


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(32, seed=3))[None]
    m = 32 * 32 // 4  # 4x undersampling
    psnr = PSNR()
    out = {}
    with torch.no_grad():
        for ordering in ORDERINGS:
            cam = SinglePixelCamera(m=m, img_size=(1, 32, 32), ordering=ordering, device=dev)
            # a DecomposablePhysics: A_dagger is closed-form (mask, inverse WHT)
            out[f"psnr_dagger_{ordering}"] = float(psnr(cam.A_dagger(cam.A(x.to(dev))),
                                                        x.to(dev))[0])
            print(f"{ordering:>12s}: m={m} adjoint-recon PSNR "
                  f"{out[f'psnr_dagger_{ordering}']:6.2f} dB")
    # PnP under noise recovers the missing high frequencies
    cam = SinglePixelCamera(m=m, img_size=(1, 32, 32), ordering="cake_cutting",
                            noise_model=GaussianNoise(0.01, device="cpu"), device="cpu")
    y = cam(x, generator=_util.generator(0))
    cam, x, y = cam.to(dev), x.to(dev), y.to(dev)
    with torch.no_grad():
        model = optim_builder("HQS", data_fidelity=L2(), prior=PnP(WaveletDenoiser("db4", 3)),
                              params_algo={"stepsize": 1.0, "g_param": 0.02},
                              max_iter=_util.scale(30, 10, fast), device=dev)
        out["psnr_pnp"] = float(psnr(model(y, cam), x)[0])
        out["psnr_dagger"] = float(psnr(cam.A_dagger(y), x)[0])
    print(f"PnP-HQS (wavelet prior) PSNR: {out['psnr_pnp']:.2f} dB vs dagger "
          f"{out['psnr_dagger']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

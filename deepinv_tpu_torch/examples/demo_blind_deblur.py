"""Blind deblurring (port of examples/demo_blind_deblur.py): a 3x64x64
image under a space-varying blur of two 9x9 diffraction kernels with
smooth masks and noise 0.01; a kernel identification network estimates four
33x33 kernels and their multipliers from the measurement alone, and 8
PnP-PGD iterations with a DnCNN prior solve on the estimated operator. The
networks are untrained here (random weights from a seed): the demo shows
the pipeline's shapes and a finite reconstruction; load the published
checkpoints for real blind deblurring.
"""

import numpy as np
import torch

from ..loss.metric import PSNR
from ..models import DnCNN, KernelIdentificationNetwork
from ..optim import L2, PnP, optim_builder
from ..physics import GaussianNoise, SpaceVaryingBlur
from ..physics.generator import DiffractionBlurGenerator
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    H = W = 64
    x = torch.from_numpy(np.random.default_rng(0).random((1, 3, H, W)).astype(np.float32))
    # the true space-varying blur: two diffraction kernels, smooth masks
    psfs = DiffractionBlurGenerator((9, 9), device="cpu").step(
        2, generator=_util.generator(1))["filter"]  # (2, 1, 9, 9)
    gx = torch.linspace(0, 1, W)[None, :] * torch.ones(H, 1)
    masks = torch.stack([gx, 1.0 - gx])[None, None]  # (1, 1, 2, H, W)
    physics_true = SpaceVaryingBlur(filters=psfs.transpose(0, 1)[None], multipliers=masks,
                                    padding="reflect",
                                    noise_model=GaussianNoise(0.01, device="cpu"), device="cpu")
    y = physics_true(x, generator=_util.generator(2))
    x, y = x.to(dev), y.to(dev)
    print(f"blurry: {tuple(y.shape)}")
    # the blind step: kernels and masks from y alone
    kin = KernelIdentificationNetwork(filters=4, blur_kernel_size=33, pretrained=None,
                                      generator=_util.generator(3), device=dev)
    psnr = PSNR()
    with torch.no_grad():
        est = kin(y)
        print(f"estimated filters: {tuple(est['filters'].shape)} multipliers: "
              f"{tuple(est['multipliers'].shape)}")
        physics_est = SpaceVaryingBlur(filters=est["filters"], multipliers=est["multipliers"],
                                       padding="reflect", device=dev)
        # the non-blind solve on the estimated operator
        model = optim_builder("PGD", data_fidelity=L2(),
                              prior=PnP(DnCNN(3, 3, pretrained=None,
                                              generator=_util.generator(4), device=dev)),
                              params_algo={"stepsize": 1.0, "g_param": 0.03},
                              max_iter=_util.scale(8, 2, fast), device=dev)
        xhat = model(y, physics_est)
    out = {"filters_shape": list(est["filters"].shape),
           "multipliers_shape": list(est["multipliers"].shape),
           "xhat_finite": bool(torch.isfinite(xhat).all()), "xhat_shape": list(xhat.shape),
           "psnr_y": float(psnr(y, x)[0]), "psnr_xhat": float(psnr(xhat, x)[0])}
    print(f"PSNR blurry: {out['psnr_y']:.2f} -> recon: {out['psnr_xhat']:.2f} (KIN and DnCNN "
          f"are untrained here: load the published checkpoints for real blind deblurring)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""A tour of MRI (port of examples/demo_mri_tour.py): the three acceleration
mask generators, single-coil masked FFT with a zero-filled and a TV-PGD
reconstruction (20 iterations whose TV prox runs the Chambolle kernel on the
card over the real and imaginary planes), multi-coil MRI with four synthetic
birdcage maps, and dynamic k-t MRI with an adjointness test.

The Shepp-Logan phantom at 128x128 (64x64 in the fast mode), 4x acceleration,
noise 0.01. The TV-PGD reconstruction is returned under ``x_hat``.
"""

import torch

from ..datasets import shepp_logan
from ..loss.metric import PSNR
from ..optim import L2, TVPrior, optim_builder
from ..physics import MRI, DynamicMRI, GaussianNoise, MultiCoilMRI
from ..physics.generator import (EquispacedMaskGenerator, GaussianMaskGenerator,
                                 RandomMaskGenerator)
from . import _util


def birdcage_maps(H: int, W: int) -> torch.Tensor:
    """Four smooth complex coil maps at the corners, normalised to unit
    root-sum-of-squares: ``(coils, H, W)`` complex64."""
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, H), torch.linspace(-1, 1, W), indexing="ij")
    maps = torch.stack([torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2))
                        * torch.exp(1j * (cx * xx + cy * yy))
                        for cy, cx in ((-1, -1), (-1, 1), (1, -1), (1, 1))])
    return (maps / maps.abs().square().sum(0, keepdim=True).sqrt()).to(torch.complex64)


def main(device=None, fast=False):
    dev = _util.device(device)
    H = W = 64 if fast else 128
    psnr = PSNR(complex_abs=True)
    ph = torch.from_numpy(shepp_logan(H))
    x = torch.stack([ph, torch.zeros_like(ph)])[None]  # (1, 2, H, W) real/imag
    out = {"sampling_rate": {}}
    # acceleration masks from the generators
    for Gen in (GaussianMaskGenerator, RandomMaskGenerator, EquispacedMaskGenerator):
        mask = Gen((H, W), acceleration=4, device="cpu").step(
            1, generator=_util.generator(0))["mask"]
        out["sampling_rate"][Gen.__name__] = float(mask.mean())
        print(f"{Gen.__name__}: mask {tuple(mask.shape)}, sampling rate "
              f"{out['sampling_rate'][Gen.__name__]:.3f}")
    mask = GaussianMaskGenerator((H, W), acceleration=4, device="cpu").step(
        1, generator=_util.generator(1))["mask"][0]
    # single-coil masked FFT
    physics = MRI(mask=mask, img_size=(H, W), noise_model=GaussianNoise(0.01, device="cpu"),
                  device="cpu")
    y = physics(x, generator=_util.generator(2))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    with torch.no_grad():
        out["psnr_zero_filled"] = float(psnr(physics.A_adjoint(y), x)[0])
        print(f"single-coil y: {tuple(y.shape)}  zero-filled PSNR: {out['psnr_zero_filled']:.2f}")
        # TV strength = lambda * stepsize (g_param is only the denoiser sigma)
        model = optim_builder("PGD", data_fidelity=L2(), prior=TVPrior(),
                              params_algo={"stepsize": 1.0, "lambda": 0.002},
                              max_iter=_util.scale(20, 5, fast), device=dev)
        xhat = model(y, physics)
        out["psnr_tv"] = float(psnr(xhat, x)[0])
        print(f"TV-PGD PSNR: {out['psnr_tv']:.2f}")
        # multi-coil with birdcage-style synthetic maps
        mc = MultiCoilMRI(mask=mask.to(dev), coil_maps=birdcage_maps(H, W)[None].to(dev),
                          img_size=(H, W), device=dev)
        y_mc = mc.A(x)
        out["psnr_coil_adjoint"] = float(psnr(mc.A_adjoint(y_mc), x)[0])
        print(f"multi-coil y: {tuple(y_mc.shape)} (B, C, coils, H, W); coil-combined adjoint "
              f"PSNR: {out['psnr_coil_adjoint']:.2f}")
        # dynamic (k-t) MRI
        T = 4
        xt = torch.stack([x[0]] * T, dim=1)[None]  # (1, 2, T, H, W)
        kt_mask = torch.stack([EquispacedMaskGenerator((H, W), acceleration=4, device="cpu").step(
            1, generator=_util.generator(10 + t))["mask"][0, 0] for t in range(T)])[None, None]
        dyn = DynamicMRI(mask=kt_mask.to(dev), img_size=(T, H, W), device=dev)
        y_dyn = dyn.A(xt)
        out["dynamic_adjointness"] = float(abs(dyn.adjointness_test(
            xt, generator=torch.Generator(dev).manual_seed(3))))
        print(f"dynamic y: {tuple(y_dyn.shape)} (k-t acquisition); adjointness "
              f"|<Ax,y>-<x,A'y>|: {out['dynamic_adjointness']:.3g}")
    out["x_hat"] = {"tv_pgd": xhat}
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""A tour of blurs (port of examples/demo_blur_tour.py): a fixed Gaussian
spatial blur; the motion, Gaussian and diffraction PSF generators, each
deblurred by BlurFFT's closed-form ``prox_l2``; and a space-varying blur by
the product-convolution expansion (six eigen-PSFs of 17x17 diffraction
kernels), held to adjointness within 1e-4. The 64x64 image and the noise
0.01 are the JAX demo's.
"""

import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..ops import gaussian_blur
from ..physics import Blur, BlurFFT, GaussianNoise, SpaceVaryingBlur
from ..physics.generator import (DiffractionBlurGenerator, GaussianBlurGenerator,
                                 MotionBlurGenerator, ProductConvolutionBlurGenerator)
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    H = W = 64
    x = torch.from_numpy(random_circles(H, seed=3)).reshape(1, 1, H, W)
    psnr = PSNR()
    # a fixed Gaussian kernel, spatial convolution
    blur = Blur(filter=gaussian_blur(sigma=2.0), padding="circular",
                noise_model=GaussianNoise(0.01, device="cpu"), device="cpu")
    y = blur(x, generator=_util.generator(0))
    out = {"psnr_blur": float(psnr(y, x)[0])}
    print(f"Blur(gaussian):      y {tuple(y.shape)}  PSNR(y, x) = {out['psnr_blur']:.2f} dB")
    x = x.to(dev)
    # the generator zoo: each step() draws a batch of PSFs
    for name, gen in [("motion", MotionBlurGenerator((25, 25), l=0.6, sigma=0.5, device="cpu")),
                      ("gaussian", GaussianBlurGenerator((25, 25), device="cpu")),
                      ("diffraction", DiffractionBlurGenerator((25, 25), device="cpu"))]:
        k = gen.step(batch_size=1, generator=_util.generator(1))["filter"]
        p = BlurFFT((1, H, W), filter=k, noise_model=GaussianNoise(0.01, device="cpu"),
                    device="cpu")
        yk = p(x.cpu(), generator=_util.generator(1))
        p, yk = p.to(dev), yk.to(dev)
        with torch.no_grad():
            # the closed-form deblurring prox (a DecomposablePhysics): one FFT solve
            xr = p.prox_l2(p.A_adjoint(yk), yk, gamma=1e3)
        out[f"psnr_y_{name}"], out[f"psnr_prox_{name}"] = (float(psnr(yk, x)[0]),
                                                           float(psnr(xr, x)[0]))
        print(f"BlurFFT({name:11s}): psf {tuple(k.shape)}  PSNR(y) "
              f"{out[f'psnr_y_{name}']:5.2f} -> prox_l2 {out[f'psnr_prox_{name}']:5.2f} dB")
    # space-varying blur: the product-convolution expansion
    pc_gen = ProductConvolutionBlurGenerator(
        psf_generator=DiffractionBlurGenerator((17, 17), device="cpu"), img_size=(H, W),
        n_eigen_psf=6, device="cpu")
    params = pc_gen.step(batch_size=1, generator=_util.generator(2))
    svb = SpaceVaryingBlur(filters=params["filters"].to(dev),
                           multipliers=params["multipliers"].to(dev), padding="circular",
                           device=dev)
    with torch.no_grad():
        ysv = svb.A(x)
        u = torch.randn(x.shape, generator=_util.generator(2)).to(dev)
        v = torch.randn(ysv.shape, generator=_util.generator(3)).to(dev)
        lhs = torch.vdot(svb.A(u).flatten(), v.flatten())
        rhs = torch.vdot(u.flatten(), svb.A_adjoint(v).flatten())
    out["svb_adjointness"] = float(abs(lhs - rhs) / abs(lhs))
    print(f"SpaceVaryingBlur:    y {tuple(ysv.shape)}  adjointness {out['svb_adjointness']:.2e}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

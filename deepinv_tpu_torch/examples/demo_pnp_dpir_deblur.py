"""DPIR deblurring (port of examples/demo_pnp_dpir_deblur.py): 8 iterations
of PnP-HQS with a decreasing denoiser level on a 3x256x256 Shepp-Logan
image blurred by a Gaussian of width 2 with noise 0.03.

With ``pretrained`` (the path of an upstream DRUNet ``.pth``) the denoiser
is that DRUNet; without it a TV denoiser (30 Chambolle steps at a tenth of
the level, the Chambolle kernel on the card) stands in, so that the demo
needs no download. The reconstruction is returned under ``x_hat``.
"""

import time

import torch

from ..datasets import shepp_logan
from ..loss import PSNR
from ..models import DRUNet, TVDenoiser
from ..ops import gaussian_blur
from ..optim import DPIR
from ..physics import BlurFFT, GaussianNoise
from . import _util


def main(device=None, fast=False, pretrained=None, size=None, sigma_noise=0.03, save_fn=None):
    dev = _util.device(device)
    size = (64 if fast else 256) if size is None else size
    x = torch.from_numpy(shepp_logan(size))[None, None].repeat(1, 3, 1, 1)
    physics = BlurFFT((3, size, size), filter=gaussian_blur(sigma=2.0),
                      noise_model=GaussianNoise(sigma_noise, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)

    if pretrained:
        denoiser = DRUNet(pretrained=pretrained, device=dev)
    else:
        # the classical stand-in, so that the demo needs no download
        tv = TVDenoiser(30)
        denoiser = lambda u, s: tv(u, 0.1 * s)
    model = DPIR(sigma=sigma_noise, denoiser=denoiser, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        xhat = model(y, physics)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x).mean()), "psnr_xhat": float(psnr(xhat, x).mean()),
           "seconds": seconds, "x_hat": {"dpir": xhat}}
    print(f"run: {seconds:.2f}s")
    print(f"PSNR y: {out['psnr_y']:.2f} dB -> xhat: {out['psnr_xhat']:.2f} dB")
    if save_fn:
        from ..utils import plot

        plot([x, y, xhat], titles=["x", "y", "DPIR"], save_fn=save_fn, show=False)
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

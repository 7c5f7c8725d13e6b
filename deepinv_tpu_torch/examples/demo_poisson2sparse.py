"""Poisson2Sparse on one image (port of examples/demo_poisson2sparse.py): a
64x64 image of about 20 photons at its peak (Poisson noise, gain 0.05). The
classical baseline stabilises the noise with the Anscombe transform and
takes a 3x3 median in its domain; Poisson2Sparse fits a ConvLISTA of 5
iterations and 16 filters to this one measurement for 300 Adam steps (lr
2e-3), each step mapping a random neighbour sub-image of every 2x2 cell to
another. Both beat the noisy image.
"""

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import AnscombeDenoiser, MedianFilter, Poisson2Sparse
from ..physics import Denoising, PoissonNoise
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    steps = _util.scale(300, 100, fast)
    x = torch.from_numpy(random_circles(64, seed=5))[None] * 0.8 + 0.1
    gain = 0.05  # ~20 photons at the peak: strong shot noise
    physics = Denoising(noise_model=PoissonNoise(gain=gain, device="cpu"))
    y = physics(x, generator=_util.generator(0))
    x, y = x.to(dev), y.to(dev)
    psnr = PSNR()

    # the classical baseline: Anscombe variance stabilisation + a median step
    with torch.no_grad():
        x_ans = AnscombeDenoiser(MedianFilter(kernel_size=3), gain=gain)(y, 0.1)
    # Poisson2Sparse: a ConvLISTA fitted to this one measurement
    p2s = Poisson2Sparse(n_iter=5, n_filters=16, train_steps=steps, lr=2e-3,
                         generator=_util.generator(1), device=dev)
    x_p2s = p2s(y, generator=torch.Generator(dev).manual_seed(2))
    out = {"psnr_y": float(psnr(y, x)[0]), "psnr_anscombe_median": float(psnr(x_ans, x)[0]),
           "psnr_poisson2sparse": float(psnr(x_p2s, x)[0])}
    print(f"noisy (gain={gain})      PSNR: {out['psnr_y']:6.2f} dB")
    print(f"Anscombe + median        PSNR: {out['psnr_anscombe_median']:6.2f} dB")
    print(f"Poisson2Sparse (1 image) PSNR: {out['psnr_poisson2sparse']:6.2f} dB "
          f"({steps} steps)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

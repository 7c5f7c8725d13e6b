"""Deep Image Prior (port of examples/demo_dip.py): 800 Adam steps fit an
untrained convolutional decoder to a 32x32 inpainting measurement (30% of
the pixels kept, noise 0.02); the network's output beats the measurement.
"""

import torch

from ..datasets import random_circles
from ..loss.metric import PSNR
from ..models import ConvDecoder, DeepImagePrior
from ..physics import GaussianNoise, Inpainting
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(32, seed=1))[None]
    physics = Inpainting((1, 32, 32), mask=0.3, generator=_util.generator(0),
                         noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(1))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    decoder = ConvDecoder((1, 32, 32), generator=_util.generator(0), device=dev)
    model = DeepImagePrior(decoder, img_shape=(1, 32, 32),
                           iterations=_util.scale(800, 100, fast), lr=3e-2)
    xhat = model(y, physics, generator=torch.Generator(dev).manual_seed(2))
    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x)[0]), "psnr_xhat": float(psnr(xhat, x)[0])}
    print(f"measurement PSNR   : {out['psnr_y']:.2f} dB")
    print(f"DIP reconstruction : {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Pansharpening (port of examples/demo_pansharpening.py): a synthetic
3-band 64x64 scene seen as a 4x downsampled multispectral image and a
panchromatic image; the Brovey fusion against 30 PnP-PGD iterations from it
whose prior is a 15-step TV denoiser, the Chambolle kernel on the card over
the three bands. The PnP reconstruction is returned under ``x_hat``.
"""

import numpy as np
import torch

from ..datasets import shepp_logan
from ..loss import PSNR
from ..models import TVDenoiser
from ..optim import L2, PnP, optim_builder
from ..physics import Pansharpen
from . import _util


def main(device=None, fast=False, size=64, factor=4):
    dev = _util.device(device)
    base = shepp_logan(size)
    x = torch.from_numpy(np.stack([base, np.roll(base, 3, 0), np.roll(base, -3, 1)]))[None]
    x = x.to(dev)
    physics = Pansharpen((3, size, size), factor=factor, device=dev)
    tv = TVDenoiser(15)
    psnr = PSNR()
    with torch.no_grad():
        y = physics.A(x)  # a TensorList: the low-resolution bands, the panchromatic
        brovey = physics.brovey(y)
        model = optim_builder("PGD", data_fidelity=L2(), prior=PnP(lambda u, s: tv(u, 0.001)),
                              params_algo={"stepsize": 0.9, "g_param": 0.05},
                              max_iter=_util.scale(30, 10, fast),
                              custom_init=lambda yv, p: p.brovey(yv), device=dev)
        xhat = model(y, physics)
    out = {"psnr_brovey": float(psnr(brovey, x).mean()), "psnr_xhat": float(psnr(xhat, x).mean()),
           "x_hat": {"pnp_tv": xhat}}
    print(f"Brovey baseline: {out['psnr_brovey']:.2f} dB -> PnP-TV: {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

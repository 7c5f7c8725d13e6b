"""Unfolded PGD for CT from the FBP (port of
examples/demo_ct_fbp_unfolded.py): 20 unfolded PGD iterations with a TV
denoiser (30 Chambolle steps, the kernel on the card) as the prior, started
from the FBP, on a 64x64 Shepp-Logan phantom at 60 angles (the Fourier-slice
projector). Swap the TV prox for ``PnP(DnCNN(...))`` and train with the
``Trainer`` for the learned variant. The reconstruction is returned under
``x_hat``.
"""

import torch

from ..datasets import shepp_logan
from ..loss import PSNR
from ..models import TVDenoiser
from ..optim import L2, PnP
from ..physics import Tomography
from ..unfolded import unfolded_builder
from . import _util


def main(device=None, fast=False, size=None, angles=60):
    dev = _util.device(device)
    size = (32 if fast else 64) if size is None else size
    x = torch.from_numpy(shepp_logan(size))[None, None].to(dev)
    physics = Tomography(angles=angles, img_width=size, normalize=True, method="fourier",
                         device=dev)
    psnr = PSNR()
    with torch.no_grad():
        y = physics.A(x)
        fbp = physics.A_dagger(y)
        tv = TVDenoiser(30)
        model = unfolded_builder("PGD", data_fidelity=L2(), prior=PnP(lambda u, s: tv(u, 0.003)),
                                 params_algo={"stepsize": 0.9, "g_param": 0.05}, max_iter=20,
                                 custom_init=lambda yv, p: p.A_dagger(yv), device=dev)
        xhat = model(y, physics)
    out = {"psnr_fbp": float(psnr(fbp, x).mean()), "psnr_xhat": float(psnr(xhat, x).mean()),
           "x_hat": {"unfolded_pgd_tv": xhat}}
    print(f"FBP PSNR: {out['psnr_fbp']:.2f} dB")
    print(f"unfolded PGD-TV PSNR: {out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

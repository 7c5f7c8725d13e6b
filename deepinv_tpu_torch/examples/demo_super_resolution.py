"""Super-resolution (port of examples/demo_super_resolution.py): 4x
downsampling of a 64x64 image behind a Gaussian, a bicubic or no
anti-aliasing filter, each upsampled by the rescaled adjoint and by the
closed-form pseudo-inverse; then noisy (0.02) 4x SR by 20 PnP-HQS iterations
whose data step is the closed-form prox (two FFTs) and whose prior is a 3x3
median, against the pseudo-inverse.
"""

import torch

from ..datasets import random_circles
from ..loss import PSNR
from ..models import MedianFilter
from ..ops import gaussian_blur
from ..ops.conv import bicubic_filter
from ..optim import L2, PnP, optim_builder
from ..physics import Downsampling, GaussianNoise
from . import _util


def main(device=None, fast=False, factor=4):
    dev = _util.device(device)
    x = torch.from_numpy(random_circles(64, seed=2))[None]
    psnr = PSNR()
    out = {}
    print(f"{'filter':>10s}  {'A_adjoint':>9s}  {'A_dagger':>8s}")
    xd = x.to(dev)
    with torch.no_grad():
        for name, filt in [("gaussian", gaussian_blur(sigma=1.5)),
                           ("bicubic", bicubic_filter(factor)), ("none", None)]:
            p = Downsampling((1, 64, 64), factor=factor, filter=filt, device=dev)
            y = p.A(xd)
            # the rescaled adjoint (a plain zero fill without a filter)
            up_adj = p.A_adjoint(y) * (factor ** 2 if filt is not None else 1)
            out[f"psnr_adjoint_{name}"] = float(psnr(up_adj, xd)[0])
            out[f"psnr_dagger_{name}"] = float(psnr(p.A_dagger(y), xd)[0])
            print(f"{name:>10s}  {out[f'psnr_adjoint_{name}']:8.2f}  "
                  f"{out[f'psnr_dagger_{name}']:8.2f}")
    # noisy SR: PnP-HQS whose data step is the exact closed-form prox
    physics = Downsampling((1, 64, 64), factor=factor, filter=gaussian_blur(sigma=1.5),
                           noise_model=GaussianNoise(0.02, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, y = physics.to(dev), y.to(dev)
    with torch.no_grad():
        model = optim_builder("HQS", data_fidelity=L2(), prior=PnP(MedianFilter(kernel_size=3)),
                              params_algo={"stepsize": 4.0, "g_param": 0.05},
                              max_iter=_util.scale(20, 10, fast), device=dev)
        out["psnr_xhat"] = float(psnr(model(y, physics), xd)[0])
        out["psnr_dagger"] = float(psnr(physics.A_dagger(y), xd)[0])
    print(f"4x SR, noise 0.02: dagger {out['psnr_dagger']:.2f} dB -> PnP-HQS "
          f"{out['psnr_xhat']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Volumetric CNN denoisers and 2D-to-3D weight inflation (port of
examples/demo_3d_cnn_denoisers.py). Most pretrained denoisers are 2-D,
while CT, MRI and microscopy stacks are volumes. A small 2-D DnCNN is
trained (Adam, autograd) on noisy/clean slices of tube phantoms at noise
0.2; applied slice by slice it ignores the depth. The same architecture
with cube kernels (``dim=3``), initialised from the 2-D weights by
:func:`initialize_3d_from_2d` (each 2-D kernel on the central depth slice),
reproduces the slice-wise result before any training (within 1e-5), and a
short supervised fine-tune on volumes then exploits the depth correlation.
"""

import numpy as np
import torch

from ..loss import PSNR
from ..models import DnCNN, initialize_3d_from_2d
from . import _util

SIGMA = 0.2


def smooth_volume(D=8, H=32, W=32, seed=0) -> torch.Tensor:
    """A tube whose cross-section drifts slowly with the depth, with a
    little texture: ``(1, 1, D, H, W)``."""
    r = np.random.default_rng(seed)
    cy, cx = H / 2, W / 2
    vol = np.zeros((D, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for d in range(D):
        oy, ox = 3 * np.sin(d / D * np.pi), 3 * np.cos(d / D * np.pi)
        vol[d] = ((yy - cy - oy) ** 2 + (xx - cx - ox) ** 2) < (H / 4) ** 2
    vol += 0.05 * r.standard_normal(vol.shape).astype(np.float32)
    return torch.from_numpy(vol)[None, None]


def train(model, make_batch, steps: int, lr: float):
    """``steps`` Adam steps on the mean squared error of ``model(y, SIGMA)``."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for i in range(steps):
        xt, yt = make_batch(i)
        opt.zero_grad()
        torch.mean((model(yt, SIGMA) - xt) ** 2).backward()
        opt.step()
    return model


def main(device=None, fast=False):
    dev = _util.device(device)
    D = 8

    def noisy(xt, seed):
        return xt, xt + SIGMA * torch.randn(xt.shape, generator=_util.generator(seed))

    x, y = noisy(smooth_volume(D=D), 0)
    x, y = x.to(dev), y.to(dev)
    psnr = PSNR()

    # a small 2-D DnCNN trained on noisy/clean slices (the stand-in for a
    # pretrained 2-D checkpoint)
    def slice_batch(i):
        xt, yt = noisy(smooth_volume(D=D, seed=100 + i), 1000 + i)
        return xt[0].transpose(0, 1).to(dev), yt[0].transpose(0, 1).to(dev)

    den2d = train(DnCNN(1, 1, depth=4, nf=8, dim=2, generator=_util.generator(1), device=dev),
                  slice_batch, _util.scale(120, 10, fast), 2e-3)
    with torch.no_grad():
        # option 1: slice-wise 2-D application (the depth folded into the batch)
        x2d = den2d(y[0].transpose(0, 1), SIGMA).transpose(0, 1)[None]
        # option 2: the 3-D network inflated from the 2-D weights (axial)
        den3d = DnCNN(1, 1, depth=4, nf=8, dim=3, generator=_util.generator(2), device=dev)
        initialize_3d_from_2d(den3d, {k: v.cpu() for k, v in den2d.state_dict().items()})
        out = {"inflation_max_diff": float((den3d(y, SIGMA) - x2d).abs().max()),
               "psnr_noisy": float(psnr(y, x).mean()), "psnr_2d": float(psnr(x2d, x).mean())}
    print(f"inflated-3D vs slice-wise-2D (pre-finetune) max |diff|: "
          f"{out['inflation_max_diff']:.2e}")
    print(f"noisy volume        PSNR: {out['psnr_noisy']:6.2f} dB")
    print(f"slice-wise 2D DnCNN PSNR: {out['psnr_2d']:6.2f} dB")

    # a short supervised fine-tune of the 3-D network on volume pairs
    def vol_batch(i):
        xt, yt = noisy(smooth_volume(D=D, seed=10 + i), 2000 + i)
        return xt.to(dev), yt.to(dev)

    train(den3d, vol_batch, _util.scale(80, 8, fast), 1e-3)
    with torch.no_grad():
        out["psnr_3d_finetuned"] = float(psnr(den3d(y, SIGMA), x).mean())
    print(f"fine-tuned 3D DnCNN PSNR: {out['psnr_3d_finetuned']:6.2f} dB (exploits depth "
          f"correlation)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

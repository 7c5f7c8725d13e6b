"""Transforms as group elements (port of examples/demo_transforms.py):
transforms compose (``*``) and stack (``+``); a sampled shift inverts
exactly (within 1e-5); and ``EquivariantDenoiser`` averages an anisotropic
1x7 horizontal box filter over a drawn rotation and a drawn reflection, on
a 64x64 phantom at noise 0.1. The average is a Monte-Carlo one: a draw
with a quarter turn makes the filter more isotropic and gains; the draw of
seed 0 (on the CPU, so that the card and the CPU draw alike) is no turn and
no flip, and the average is the filter itself.
"""

import torch
import torch.nn.functional as F

from ..datasets import shepp_logan
from ..loss import PSNR
from ..models import EquivariantDenoiser
from ..transform import Reflect, Rotate, Shift
from . import _util


def box_1x7(u, sigma=None):
    """A horizontal-only smoother: the anisotropic filter to symmetrize."""
    k = torch.ones((1, 1, 1, 7), dtype=u.dtype, device=u.device) / 7.0
    return F.conv2d(u, k, padding=(0, 3))


def main(device=None, fast=False, size=64, sigma=0.1):
    dev = _util.device(device)
    x = torch.from_numpy(shepp_logan(size))[None, None]
    y = (x + sigma * torch.randn(x.shape, generator=_util.generator(2))).to(dev)
    x = x.to(dev)
    t = Rotate(multiples=90) * Reflect()
    tx = t(x, generator=_util.generator(0))
    print(f"transformed batch: {tuple(tx.shape)}")
    shift = Shift()
    params = shift.get_params(x, generator=_util.generator(1))
    out = {"shift_round_trip": float((shift.inverse(shift.transform(x, **params), **params)
                                      - x).abs().max())}
    print(f"shift round-trip max error {out['shift_round_trip']:.1e}")
    # averaging the anisotropic filter over the rotation group restores
    # isotropy and improves denoising
    equiv = EquivariantDenoiser(box_1x7, transform=Rotate(multiples=90) + Reflect())
    psnr = PSNR()
    with torch.no_grad():
        out["psnr_anisotropic"] = float(psnr(box_1x7(y), x).mean())
        out["psnr_equivariant"] = float(psnr(equiv(y, sigma, generator=_util.generator(0)),
                                                x).mean())
    print(f"anisotropic     {out['psnr_anisotropic']:.2f} dB")
    print(f"equivariant     {out['psnr_equivariant']:.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

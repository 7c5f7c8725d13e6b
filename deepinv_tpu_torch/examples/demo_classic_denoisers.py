"""The classic denoisers (port of examples/demo_classic_denoisers.py) on a
96x96 Shepp-Logan phantom at noise 25/255: a 3x3 median, db4 wavelets, TV
(100 Chambolle steps, the kernel on the card) and BM3D (a search radius of
8, a reference every 3 pixels), each against the noisy input. The TV output
is returned under ``x_hat``.
"""

import torch

from ..datasets import shepp_logan
from ..loss.metric import PSNR
from ..models import BM3D, MedianFilter, TVDenoiser, WaveletDenoiser
from . import _util

SIGMA = 25 / 255


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(shepp_logan(96))[None, None]
    y = (x + SIGMA * torch.randn(x.shape, generator=_util.generator(0))).to(dev)
    x = x.to(dev)
    psnr = PSNR()
    out = {"psnr_y": float(psnr(y, x)[0]), "psnr": {}}
    print(f"noisy             {out['psnr_y']:5.2f} dB")
    with torch.no_grad():
        for name, den, ths in [("median 3x3", MedianFilter(3), None),
                               ("wavelet db4", WaveletDenoiser(wv="db4", level=3), SIGMA),
                               ("TV (Chambolle)", TVDenoiser(100), 0.12),
                               ("BM3D", BM3D(search_radius=8, ref_stride=3), SIGMA)]:
            den_out = den(y) if ths is None else den(y, ths)
            out["psnr"][name] = float(psnr(den_out, x)[0])
            if name.startswith("TV"):
                out["x_hat"] = {"tv": den_out}
            print(f"{name:18s}{out['psnr'][name]:5.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

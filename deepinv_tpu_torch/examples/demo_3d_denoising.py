"""Volumetric wavelet denoising (port of examples/demo_3d_denoising.py): a
16x64x64 phantom of ellipsoids at noise 0.3, denoised by 2D db4 wavelets
slice by slice, by 3D db4 wavelets (``wvdim=3``) and by a dictionary of 3D
wavelets (db2, db4, db8).
"""

import numpy as np
import torch

from ..loss import PSNR
from ..models import WaveletDenoiser, WaveletDictDenoiser
from . import _util


def phantom_volume(D=16, H=64, W=64):
    """Smooth ellipsoidal blobs: a stand-in for a CT or microscopy volume."""
    z, y, x = np.mgrid[0:D, 0:H, 0:W].astype(np.float32)
    v = np.zeros((D, H, W), np.float32)
    for (cz, cy, cx, rz, ry, rx, a) in [(8, 32, 32, 6, 22, 22, 1.0), (8, 24, 40, 3, 8, 6, -0.4),
                                        (10, 44, 24, 4, 7, 9, -0.6), (5, 30, 30, 2, 5, 5, 0.5)]:
        m = ((z - cz) / rz) ** 2 + ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2
        v += a * (m < 1)
    return np.clip(v, 0, 1)


def main(device=None, fast=False):
    dev = _util.device(device)
    x = torch.from_numpy(phantom_volume())[None, None]  # (1, 1, D, H, W)
    sigma = 0.3  # heavier noise: the redundancy across slices pays
    noisy = x + sigma * torch.randn(x.shape, generator=_util.generator(0))
    x, noisy = x.to(dev), noisy.to(dev)
    psnr = PSNR()
    B, C, D, H, W = noisy.shape
    with torch.no_grad():
        # slice by slice: depth folded into the batch
        x2d = WaveletDenoiser("db4", level=2, wvdim=2)(
            noisy.permute(0, 2, 1, 3, 4).reshape(B * D, C, H, W), sigma
        ).reshape(B, D, C, H, W).permute(0, 2, 1, 3, 4)
        x3d = WaveletDenoiser("db4", level=2, wvdim=3)(noisy, sigma)
        xdict = WaveletDictDenoiser(("db2", "db4", "db8"), level=2, wvdim=3)(noisy, sigma)
    out = {"psnr_noisy": float(psnr(noisy, x)[0]), "psnr_2d": float(psnr(x2d, x)[0]),
           "psnr_3d": float(psnr(x3d, x)[0]), "psnr_dict": float(psnr(xdict, x)[0])}
    print(f"noisy volume        PSNR: {out['psnr_noisy']:6.2f} dB")
    print(f"2D per-slice db4    PSNR: {out['psnr_2d']:6.2f} dB")
    print(f"3D db4 (wvdim=3)    PSNR: {out['psnr_3d']:6.2f} dB")
    print(f"3D wavelet dict     PSNR: {out['psnr_dict']:6.2f} dB")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

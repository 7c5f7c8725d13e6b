"""Denoising fluorescence microscopy in the FMD dataset's layout (port of
examples/demo_microscopy_denoising.py): a small on-disk tree of the
Fluorescence Microscopy Denoising dataset is written with synthetic
confocal frames (two fields of view of 128x128, photon noise of 30 photons
at the peak, raw and 2-frame averages, two frames each, beside each field's
clean ``gt/<fov>/avg50.png``), read back through ``FMD`` and denoised by a
db4 wavelet denoiser (3 levels) inside the Anscombe transform. The
denoised frames' mean PSNR beats the noisy frames'. The files are written
with PIL, imported when the demo runs.
"""

import os
import tempfile

import numpy as np
import torch

from ..datasets import FMD, random_circles
from ..loss import PSNR
from ..models import AnscombeDenoiser, WaveletDenoiser
from . import _util


def fabricate_fmd(root, img_type="Confocal_BPAE_B", fovs=(1, 2), n_frames=2, peak=30, seed=0):
    """Write an FMD-layout tree: ``<type>/{raw,avg2}/<fov>/<i>.png`` and
    ``<type>/gt/<fov>/avg50.png`` (the dataset's own directory layout)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for fov in fovs:
        clean = random_circles(128, seed=100 + fov)[0]  # (H, W) in [0, 1]
        gt_dir = os.path.join(root, img_type, "gt", str(fov))
        os.makedirs(gt_dir, exist_ok=True)
        Image.fromarray((clean * 255).astype(np.uint8)).save(os.path.join(gt_dir, "avg50.png"))
        for level, dirname in [(1, "raw"), (2, "avg2")]:
            d = os.path.join(root, img_type, dirname, str(fov))
            os.makedirs(d, exist_ok=True)
            for i in range(n_frames):
                # photon shot noise, averaged over `level` frames
                frames = rng.poisson(clean * peak * level) / (peak * level)
                Image.fromarray((np.clip(frames, 0, 1) * 255).astype(np.uint8)).save(
                    os.path.join(d, f"{i}.png"))


def main(device=None, fast=False):
    dev = _util.device(device)
    with tempfile.TemporaryDirectory() as root:
        fabricate_fmd(root)
        to_arr = lambda im: torch.from_numpy(np.asarray(im, np.float32))[None] / 255.0
        ds = FMD(root, img_types=["Confocal_BPAE_B"], noise_levels=(1, 2), fovs=(1, 2),
                 transform=to_arr, target_transform=to_arr)
        print(f"FMD loaded: {len(ds)} noisy frames (2 fovs x 2 noise levels x 2 frames)")
        den = AnscombeDenoiser(WaveletDenoiser("db4", level=3), gain=1 / 30.0)
        psnr = PSNR()
        vals_in, vals_out = [], []
        with torch.no_grad():
            for clean, noisy in ds:
                clean, noisy = clean[None].to(dev), noisy[None].to(dev)
                xhat = den(noisy, 0.6)
                vals_in.append(float(psnr(noisy, clean)[0]))
                vals_out.append(float(psnr(xhat, clean)[0]))
    out = {"n_frames": len(ds), "psnr_noisy": float(np.mean(vals_in)),
           "psnr_denoised": float(np.mean(vals_out))}
    print(f"mean PSNR noisy   : {out['psnr_noisy']:6.2f} dB")
    print(f"mean PSNR denoised: {out['psnr_denoised']:6.2f} dB (Anscombe + db4 wavelets)")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""Loading data from scientific file formats (port of examples/demo_io.py):
a 64x64 Shepp-Logan phantom written as .npy, as MATLAB .mat (scipy), as
16-bit TIFF (PIL) and as HDF5 (h5py), each read back by the port's readers
(``load_np``, ``load_mat``, ``load_tiff``) or h5py, with their shapes and
round-trip errors, and the array moved to the device, ready for a physics.
scipy, PIL and h5py are imported when the demo runs.
"""

import os
import tempfile

import numpy as np
import torch

from ..datasets import shepp_logan
from ..utils import load_mat, load_np, load_tiff
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    x = np.asarray(shepp_logan(64), np.float32)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        # numpy
        p = os.path.join(td, "phantom.npy")
        np.save(p, x)
        a = load_np(p)
        out["npy_shape"], out["npy_maxerr"] = list(a.shape), float(np.abs(a - x).max())
        print(f".npy  -> {a.shape} {a.dtype}, maxerr {out['npy_maxerr']:.1e}")

        # MATLAB .mat
        from scipy.io import savemat

        p = os.path.join(td, "phantom.mat")
        savemat(p, {"img": x, "pixel_size": 0.5})
        d = load_mat(p)
        out["mat_keys"] = sorted(k for k in d if not k.startswith("__"))
        out["mat_img_shape"] = list(d["img"].shape)
        print(f".mat  -> keys {out['mat_keys']}, img {d['img'].shape}")

        # TIFF, 16-bit (the microscopy standard)
        from PIL import Image

        p = os.path.join(td, "phantom.tif")
        Image.fromarray((x * 65535).astype(np.uint16)).save(p)
        t = load_tiff(p)
        out["tiff_shape"], out["tiff_dtype"] = list(t.shape), str(t.dtype)
        out["tiff_maxerr"] = float(np.abs(t / 65535.0 - x).max())
        print(f".tiff -> {t.shape} {t.dtype}, rescaled maxerr {out['tiff_maxerr']:.1e}")

        # HDF5 (the format of generate_dataset)
        import h5py

        p = os.path.join(td, "phantom.h5")
        with h5py.File(p, "w") as f:
            f.create_dataset("x", data=x[None, None])
        with h5py.File(p, "r") as f:
            h = np.asarray(f["x"])
        out["h5_shape"] = list(h.shape)
        print(f".h5   -> {h.shape}")

        # any of these feeds the framework
        img = torch.from_numpy(np.asarray(a))[None, None].to(dev)
        out["img_shape"], out["img_device"] = list(img.shape), str(img.device)
        print(f"ready for physics: {tuple(img.shape)} on {img.device}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

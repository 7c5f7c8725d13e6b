"""Native C++ data loading (port of examples/demo_native_dataloader.py):
32 random 96x128 RGB PNGs written to a temporary folder are read by
``ImageFolder`` at 64x64, decoded by the port's C++ decoder (libpng and
libjpeg on C++ threads) where it built, and served as 4 batches of
(8, 3, 64, 64) by the double-buffered prefetcher, each batch decoding
while the one before is consumed, and moved to the device. The PNGs are
written with PIL, imported when the demo runs.
"""

import os
import tempfile

import numpy as np

from ..datasets import ImageFolder
from ..native import native_available
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    from PIL import Image

    with tempfile.TemporaryDirectory() as root:
        # a small synthetic image folder
        rng = np.random.default_rng(0)
        for i in range(32):
            arr = (rng.uniform(0, 1, (96, 128, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, f"{i:03d}.png"))
        out = {"native": native_available()}
        print("native loader available:", out["native"])
        ds = ImageFolder(root, size=(64, 64))  # backend 'auto': the C++ decoder
        item = ds[0]
        out["item_shape"], out["item_dtype"] = list(item.shape), str(item.dtype)
        print("one item:", item.shape, item.dtype)
        # double-buffered batches: batch k+1 decodes while batch k is consumed
        out["batch_shapes"], out["batch_means"] = [], []
        for i, batch in enumerate(ds.batches(8, device=dev)):
            out["batch_shapes"].append(list(batch.shape))
            out["batch_means"].append(float(batch.mean()))
            print(f"batch {i}: {tuple(batch.shape)} on {batch.device}  "
                  f"mean={out['batch_means'][-1]:.3f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)

"""The NBU satellite pansharpening dataset (port of
deepinv_tpu/datasets/satellite.py).

The layout::

    root --- <satellite> --- MS_256/   1.mat ... N.mat   (key "imgMS")
                          -- PAN_1024/ 1.mat ... N.mat   (key "imgPAN")

Items are multispectral images ``(C, 256, 256)`` in [0, 1] as numpy arrays,
or, with ``return_pan=True``, a :class:`~deepinv_tpu_torch.core.TensorList`
of the MS and PAN tensors (on the CPU; the Trainer moves batches to the
model's device) for the pansharpening physics. Nothing is downloaded.
"""

from __future__ import annotations

import os
import re
from typing import Callable

import numpy as np

from .base import ImageDataset

__all__ = ["NBUDataset"]

SATELLITES = ("ikonos", "gaofen-1", "quickbird", "worldview-2", "worldview-3", "worldview-4")


def _natsort(paths):
    """Natural sort by file name: 2.mat before 10.mat (satellite.py:30)."""
    def key(p):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", os.path.basename(p))]

    return sorted(paths, key=key)


def _mats(folder):
    if not os.path.isdir(folder):
        return []
    return _natsort([os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".mat")])


class NBUDataset(ImageDataset):
    """The NBU dataset's ``.mat`` pairs (satellite.py:42).

    :param root_dir: the dataset's root, one folder a satellite.
    :param satellite: ``ikonos``, ``gaofen-1``, ``quickbird`` or
        ``worldview-2/3/4``.
    :param return_pan: return ``TensorList([MS, PAN])`` pairs.
    :param transform_ms: applied to the normalized MS array.
    :param transform_pan: applied to the normalized PAN array.
    :param download: refused: the port downloads nothing.
    """

    def __init__(self, root_dir: str, satellite: str = "gaofen-1", return_pan: bool = False,
                 transform_ms: Callable = None, transform_pan: Callable = None,
                 download: bool = False):
        if download:
            raise RuntimeError("NBU: the port downloads nothing; place nbu_<satellite>.zip "
                               f"extracted under {root_dir} (satellite.py:63).")
        if satellite not in SATELLITES:
            raise ValueError(f"satellite must be one of {SATELLITES}")
        self.data_dir = os.path.join(root_dir, satellite)
        # gaofen-1 is 10-bit, the others 11-bit (satellite.py:71)
        self.denom = 1023.0 if satellite == "gaofen-1" else 2047.0
        self.return_pan = return_pan
        self.transform_ms = transform_ms
        self.transform_pan = transform_pan
        self.ms_paths = _mats(os.path.join(self.data_dir, "MS_256"))
        self.pan_paths = _mats(os.path.join(self.data_dir, "PAN_1024"))
        if not self.ms_paths:
            raise FileNotFoundError(f"NBU: no MS_256/*.mat under {self.data_dir}")
        if len(self.ms_paths) != len(self.pan_paths):
            raise ValueError("NBU: MS_256 and PAN_1024 counts differ")
        for m, p in zip(self.ms_paths, self.pan_paths):
            if os.path.basename(m) != os.path.basename(p):
                raise ValueError("MS and PAN filenames do not match.")
        self.image_paths = list(zip(self.ms_paths, self.pan_paths))

    def normalize(self, a) -> np.ndarray:
        return (np.asarray(a) / self.denom).astype(np.float32)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        from scipy.io import loadmat

        ms_path, pan_path = self.image_paths[idx]
        ms = self.normalize(loadmat(ms_path)["imgMS"])
        pan = self.normalize(loadmat(pan_path)["imgPAN"])
        # HWC -> CHW
        ms = np.moveaxis(ms, -1, 0) if ms.ndim == 3 else ms[None]
        pan = pan[None] if pan.ndim == 2 else np.moveaxis(pan, -1, 0)
        if self.transform_ms is not None:
            ms = self.transform_ms(ms)
        if self.transform_pan is not None:
            pan = self.transform_pan(pan)
        if self.return_pan:
            import torch

            from ..core import TensorList

            return TensorList([torch.as_tensor(ms), torch.as_tensor(pan)])
        return ms

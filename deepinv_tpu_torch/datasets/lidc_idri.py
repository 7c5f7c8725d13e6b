"""LIDC-IDRI CT slices (port of deepinv_tpu/datasets/lidc_idri.py).

The layout of TCIA's NBIA data retriever::

    root --- metadata.csv            (columns incl. Subject ID, Modality,
         |                            File Location)
         --- LIDC-IDRI/LIDC-IDRI-xxxx/<study>/<series>/ *.dcm

The CSV's ``File Location`` is relative (Windows or POSIX separators); each
CT series folder is read in sorted order, one item a DICOM slice, as a numpy
array. Slices are read by the port's numpy DICOM reader
(:mod:`deepinv_tpu_torch.utils.dicom`): uncompressed slices need no pydicom.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, NamedTuple

import numpy as np

from ..utils.dicom import load_dicom
from .base import ImageDataset

__all__ = ["LidcIdriSliceDataset"]


class SliceSampleIdentifier(NamedTuple):
    """A slice's file name, its scan folder and the patient's id
    (lidc_idri.py:29)."""

    slice_fname: str
    scan_folder: str
    patient_id: str


class LidcIdriSliceDataset(ImageDataset):
    """CT slices of the LIDC-IDRI layout (lidc_idri.py:41).

    :param root: the folder of ``metadata.csv`` and the DICOM tree.
    :param transform: applied to each ``(H, W)`` slice.
    :param hounsfield_units: Hounsfield units through RescaleSlope/Intercept
        (float32); else the raw int16 values.
    """

    SliceSampleIdentifier = SliceSampleIdentifier

    def __init__(self, root: str, transform: Callable = None, hounsfield_units: bool = False):
        self.root = root
        self.transform = transform
        self.hounsfield_units = hounsfield_units

        csv_path = os.path.join(root, "metadata.csv")
        if not os.path.isdir(root):
            raise ValueError(f"The `root` folder doesn't exist: {root}")
        if not os.path.exists(csv_path):
            raise ValueError(f"{csv_path} doesn't exist.")
        with open(csv_path, newline="") as f:
            rows = [r for r in csv.DictReader(f) if r.get("Modality") == "CT"]
        rows.sort(key=lambda r: r["Subject ID"])

        self.sample_identifiers = []
        for r in rows:
            loc = r["File Location"].replace("\\", os.sep).replace("/", os.sep)
            folder = os.path.join(root, os.path.normpath(loc))
            self.sample_identifiers += [SliceSampleIdentifier(f, folder, r["Subject ID"])
                                        for f in sorted(os.listdir(folder)) if f.endswith(".dcm")]

    def __len__(self) -> int:
        return len(self.sample_identifiers)

    def __getitem__(self, idx: int):
        fname, folder, _ = self.sample_identifiers[idx]
        path = os.path.join(folder, fname)
        if self.hounsfield_units:
            arr = load_dicom(path, apply_rescale=True)
        else:
            arr = load_dicom(path, apply_rescale=False, dtype=np.int16)
        if self.transform is not None:
            arr = self.transform(arr)
        return arr

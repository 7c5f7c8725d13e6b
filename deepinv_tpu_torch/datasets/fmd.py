"""The Fluorescence Microscopy Denoising (FMD) dataset (port of
deepinv_tpu/datasets/fmd.py).

The layout, a folder an image type (e.g. ``Confocal_BPAE_B``)::

    root --- <img_type> --- raw   --- <fov>/ *.png   (noise level 1)
                         -- avg2  --- <fov>/ *.png   (noise level 2)
                         -- avg4 / avg8 / avg16
                         -- gt    --- <fov>/avg50.png  (the clean target)

Each item is ``(clean, noisy)``: PIL images, or what the transforms make of
them; PIL is imported where an image is read. 12 image types x 5 noise
levels x 20 fields of view x 50 images. Nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Sequence

from .base import ImageDataset

__all__ = ["FMD"]

ALL_IMG_TYPES = (
    "TwoPhoton_BPAE_R",
    "TwoPhoton_BPAE_G",
    "TwoPhoton_BPAE_B",
    "TwoPhoton_MICE",
    "Confocal_MICE",
    "Confocal_BPAE_R",
    "Confocal_BPAE_G",
    "Confocal_BPAE_B",
    "Confocal_FISH",
    "WideField_BPAE_R",
    "WideField_BPAE_G",
    "WideField_BPAE_B",
)
ALL_NOISE_LEVELS = (1, 2, 4, 8, 16)


class FMD(ImageDataset):
    """The FMD dataset's noisy images paired with their clean targets
    (fmd.py:42).

    :param root: dataset root.
    :param img_types: subset of the 12 image-type folder names (required).
    :param noise_levels: subset of (1, 2, 4, 8, 16); 1 maps to ``raw``,
        k > 1 to ``avg<k>``.
    :param fovs: fields of view (1..20).
    :param download: refused: the port downloads nothing.
    :param transform: applied to the noisy image.
    :param target_transform: applied to the clean image.
    """

    class NoisySampleIdentifier(NamedTuple):
        """One noisy PNG (fmd.py:55): the image type's folder, the noise
        folder (``raw`` or ``avg<k>``), the field of view, the file name."""

        img_type: str
        noise_dirname: str
        fov: int
        fname: str

    def __init__(
        self,
        root: str,
        img_types: Sequence[str] = None,
        noise_levels: Sequence[int] = ALL_NOISE_LEVELS,
        fovs: Sequence[int] = tuple(range(1, 21)),
        download: bool = False,
        transform: Callable = None,
        target_transform: Callable = None,
    ):
        if download:
            raise RuntimeError("FMD: the port downloads nothing; place the extracted tarballs "
                               f"under {root} (fmd.py:74).")
        if img_types is None or not all(t in ALL_IMG_TYPES for t in img_types):
            raise ValueError(
                f"Set `img_types` to values from: {list(ALL_IMG_TYPES)}"
            )
        if not all(l in ALL_NOISE_LEVELS for l in noise_levels):
            raise ValueError(f"Wrong noise level. Available: {ALL_NOISE_LEVELS}")
        self.root = root
        self.img_types = list(img_types)
        self.noise_levels = list(noise_levels)
        self.fovs = list(fovs)
        self.transform = transform
        self.target_transform = target_transform

        # (img_type, noise_dirname, fov, fname) a noisy PNG (fmd.py:92-113)
        self.noisy_sample_identifiers = []
        for img_type in self.img_types:
            for level in self.noise_levels:
                noise_dirname = "raw" if level == 1 else f"avg{level}"
                for fov in self.fovs:
                    folder = os.path.join(
                        root, img_type, noise_dirname, str(fov)
                    )
                    if not os.path.isdir(folder):
                        raise FileNotFoundError(
                            f"FMD: expected directory {folder} (layout "
                            "root/<img_type>/<noise>/<fov>/)"
                        )
                    for fname in sorted(os.listdir(folder)):
                        if fname.endswith(".png"):
                            self.noisy_sample_identifiers.append(
                                self.NoisySampleIdentifier(
                                    img_type, noise_dirname, fov, fname
                                )
                            )

    def __len__(self) -> int:
        return len(self.noisy_sample_identifiers)

    def __getitem__(self, idx: int):
        from PIL import Image

        img_type, noise_dirname, fov, fname = self.noisy_sample_identifiers[idx]
        noisy = Image.open(
            os.path.join(self.root, img_type, noise_dirname, str(fov), fname)
        )
        clean = Image.open(
            os.path.join(self.root, img_type, "gt", str(fov), "avg50.png")
        )
        if self.transform is not None:
            noisy = self.transform(noisy)
        if self.target_transform is not None:
            clean = self.target_transform(clean)
        return clean, noisy

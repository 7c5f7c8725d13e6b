"""A folder of images and the named image datasets over local files (port of
deepinv_tpu/datasets/folder.py).

The named datasets (DIV2K, Urban100, Set14, CBSD68, BSDS500, Flickr2K,
LSDIR) read the files under a local ``root``; ``download=True`` raises, as in
the JAX package. Images decode with the port's native decoder
(:mod:`deepinv_tpu_torch.native`) where it built and the item suits it, else
with PIL, imported where an image is read.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .base import ImageDataset

__all__ = ["load_image", "ImageFolder", "DIV2K", "Urban100HR", "Set14HR", "CBSD68", "BSDS500",
           "Flickr2kHR", "LsdirHR"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


def load_image(path, size=None, to_float: bool = True, grayscale: bool = False):
    """An image file as a ``(C, H, W)`` numpy array (folder.py:33), float32 in
    [0, 1] unless ``to_float`` is False; ``size`` (an int or ``(h, w)``)
    resizes it bilinearly, as the native decoder does."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    if size is not None:
        if isinstance(size, int):
            size = (size, size)
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    if to_float:
        arr = arr.astype(np.float32) / 255.0
    return arr


class ImageFolder(ImageDataset):
    """Every image under a directory, in sorted order (folder.py:58).

    :param backend: ``"auto"`` (the native decoder where it built and the item
        is a PNG or JPEG with a fixed ``size``, else PIL), ``"native"`` (the
        native decoder, or raise where it did not build) or ``"pil"``.
    """

    def __init__(self, root: str, transform: Optional[Callable] = None, size=None,
                 grayscale: bool = False, backend: str = "auto"):
        self.root = root
        self.transform = transform
        self.size = (size, size) if isinstance(size, int) else size
        self.grayscale = grayscale
        self.paths = []
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTENSIONS):
                    self.paths.append(os.path.join(dirpath, f))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._native = False
        if backend in ("auto", "native"):
            from ..native import native_available

            self._native = native_available()
            if backend == "native" and not self._native:
                raise RuntimeError("native image loader unavailable (no g++, libpng or libjpeg?)")

    def _native_usable(self, path) -> bool:
        return (self._native and self.size is not None
                and path.lower().endswith((".png", ".jpg", ".jpeg")))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        path = self.paths[i]
        if self._native_usable(path):
            from ..native import decode_image

            x = decode_image(path, (3,) + tuple(self.size), mode="resize")
            if self.grayscale:  # PIL's 'L' luma weights on the RGB decode
                x = 0.299 * x[:1] + 0.587 * x[1:2] + 0.114 * x[2:3]
        else:
            x = load_image(path, size=self.size, grayscale=self.grayscale)
        return self.transform(x) if self.transform is not None else x

    def batches(self, batch_size: int, n_threads: int = 0, device=None):
        """``(B, C, H, W)`` float32 batches decoded by the native prefetcher
        (:class:`~deepinv_tpu_torch.native.NativePrefetcher`), on ``device``
        (the CUDA device by default). Needs ``size``; decodes RGB, and
        ``C`` is 1 with ``grayscale`` (the first channel, as the JAX
        package's)."""
        if self.size is None:
            raise ValueError("batches() needs a fixed `size`")
        from ..native import NativePrefetcher

        C = 1 if self.grayscale else 3
        return NativePrefetcher(self.paths, batch_size, (C,) + tuple(self.size),
                                n_threads=n_threads, device=device)


class _PublicDataset(ImageFolder):
    """A named dataset over the files under ``root``; nothing is downloaded."""

    name = "dataset"

    def __init__(self, root: str, download: bool = False, **kwargs):
        if download:
            raise RuntimeError(f"{self.name}: downloads are not supported; place the files "
                               f"under {root} (the reference downloads them from its hub).")
        super().__init__(root, **kwargs)


class DIV2K(_PublicDataset):
    name = "DIV2K"

    # the official archives' MD5s (reference div2k.py:69)
    _checksums = {"DIV2K_train_HR": "f9de9c251af455c1021017e61713a48b",
                  "DIV2K_valid_HR": "542325e500b0a474c7ad18bae922da72"}

    def verify_split_dataset_integrity(self, mode: str = "train") -> bool:
        """Whether the split folder under ``root`` hashes to the official MD5
        (folder.py:158)."""
        from .utils import calculate_md5_for_folder

        if not os.path.isdir(self.root):
            return False
        split = "DIV2K_train_HR" if mode == "train" else "DIV2K_valid_HR"
        return calculate_md5_for_folder(os.path.join(self.root, split)) == self._checksums[split]


class Urban100HR(_PublicDataset):
    name = "Urban100"


class Set14HR(_PublicDataset):
    name = "Set14"


class CBSD68(_PublicDataset):
    name = "CBSD68"


class BSDS500(_PublicDataset):
    name = "BSDS500"


class Flickr2kHR(_PublicDataset):
    name = "Flickr2k"


class LsdirHR(_PublicDataset):
    name = "LSDIR"

    # the official archives' MD5s (reference lsdir.py:93)
    _checksums = {"train": "a83bdb97076d617e4965913195cc84d1",
                  "val": "972ba478c530b76eb9404b038597f65f"}

    def verify_split_dataset_integrity(self, mode: str = "train") -> bool:
        """Whether the split's shard folders under ``root`` hash to the
        official combined MD5 (folder.py:203)."""
        import hashlib

        from .utils import calculate_md5_for_folder

        if not os.path.isdir(self.root):
            return False
        if mode == "train":
            dirs = [os.path.join(self.root, str(i * 1000).zfill(7)) for i in range(1, 86)]
        else:
            dirs = [os.path.join(self.root, "val1", "HR", "val")]
        md5 = hashlib.md5()
        for d in dirs:
            md5.update(calculate_md5_for_folder(d).encode())
        return md5.hexdigest() == self._checksums[mode]

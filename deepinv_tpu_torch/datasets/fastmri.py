"""fastMRI slice datasets (port of deepinv_tpu/datasets/fastmri.py).

Reads fastMRI ``.h5`` volumes (k-space and reconstruction) with ``h5py``,
imported where a file is read, and serves 2-D slices as numpy arrays in the
``(2, H, W)`` real/imaginary convention, as the JAX package does:

- the pickle **metadata cache** (``load_metadata_from_cache``,
  ``save_metadata_to_cache``, ``metadata_cache_file``; fastmri.py:67-103), so
  that a large archive is not scanned at every construction;
- :class:`MRISliceTransform`, the raw-data preprocessing: a mask a sample,
  seeded per sample, k-space normalization, coil prewhitening and low-res
  coil maps (fastmri.py:219-358).

The per-sample mask draws from a ``torch.Generator`` seeded with the crc32 of
the sample's name, where the JAX package seeds a key with it: the same
semantics, the port's own masks. Nothing is downloaded.
"""

from __future__ import annotations

import os
import pickle
import warnings
import zlib
from contextlib import contextmanager
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..physics.mri import MRIMixin
from ..utils import torch2cpu
from .base import ImageDataset

__all__ = ["FastMRISliceDataset", "SimpleFastMRISliceDataset", "MRISliceTransform"]


def _ifft2c(ksp):
    """Centred orthonormal inverse 2-D FFT of the last two axes, in numpy."""
    return np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(ksp, axes=(-2, -1)), norm="ortho"),
                           axes=(-2, -1))


class FastMRISliceDataset(ImageDataset, MRIMixin):
    """Slices of raw fastMRI k-space volumes (fastmri.py:34).

    Each item is ``(x, y)``: the magnitude target ``(1, H, W)`` and the
    k-space ``(2, H, W)`` (single coil) or ``(2, N, H, W)`` (multi-coil); or
    ``(x, y, params)`` where the transform gives physics parameters (a mask,
    coil maps).

    :param root: directory of fastMRI ``.h5`` files.
    :param slice_index: ``"all"``, ``"middle"``, ``"middle+i"`` (the 2i + 1
        middle slices), ``"random"`` (one a volume), an int or a list of ints.
    :param transform: an :class:`MRISliceTransform` or a callable
        ``(x, y) -> ...``.
    :param load_metadata_from_cache: read the file and slice index from
        ``metadata_cache_file`` instead of scanning ``root``.
    :param save_metadata_to_cache: write the scanned index to
        ``metadata_cache_file``.
    """

    class SliceSampleID(NamedTuple):
        """One slice of a volume file and its metadata (fastmri.py:52)."""

        fname: str
        slice_ind: int
        metadata: dict

    @staticmethod
    def torch_shuffle(x: list, generator=None, seed: int = 0) -> list:
        """``x`` in a reproducible random order (fastmri.py:61). With no
        generator, ``numpy.random.default_rng(seed)``'s permutation, as in the
        JAX package, so that a seeded split picks the same files in both; a
        ``torch.Generator`` draws ``torch.randperm``, a numpy ``Generator``
        its ``permutation``."""
        if isinstance(generator, torch.Generator):
            order = torch.randperm(len(x), generator=generator).tolist()
        else:
            rng = generator if generator is not None else np.random.default_rng(seed)
            order = rng.permutation(len(x))
        return [x[i] for i in order]

    @contextmanager
    def metadata_cache_manager(self, root, samples):
        """Read or write the pickle metadata cache around filling ``samples``
        (fastmri.py:67): yields the cached samples where
        ``load_metadata_from_cache`` and the cache exists, else ``samples``
        for the caller to fill, saved afterwards with
        ``save_metadata_to_cache``."""
        if self.load_metadata_from_cache and os.path.exists(self.metadata_cache_file):
            with open(self.metadata_cache_file, "rb") as f:
                cache = pickle.load(f)
            if cache.get(root) is None:
                raise ValueError(
                    "`metadata_cache_file` doesn't contain the metadata. Either deactivate "
                    "`load_metadata_from_cache` or set `metadata_cache_file` properly.")
            yield cache[root]
        else:
            if self.load_metadata_from_cache and not os.path.exists(self.metadata_cache_file):
                warnings.warn(f"Couldn't find dataset cache at {self.metadata_cache_file}. "
                              "Loading dataset from scratch.")
            yield samples
            if self.save_metadata_to_cache:
                cache = {}
                if os.path.exists(self.metadata_cache_file):
                    with open(self.metadata_cache_file, "rb") as f:
                        cache = pickle.load(f)
                cache[root] = samples
                with open(self.metadata_cache_file, "wb") as f:
                    pickle.dump(cache, f)

    def __init__(self, root: str, slice_index="all", transform=None,
                 load_metadata_from_cache: bool = False, save_metadata_to_cache: bool = False,
                 metadata_cache_file="dataset_cache.pkl"):
        self.root = root
        self.transform = transform
        self.metadata_cache_file = metadata_cache_file
        self.load_metadata_from_cache = load_metadata_from_cache
        self.save_metadata_to_cache = save_metadata_to_cache

        with self.metadata_cache_manager(root, []) as metadata:
            if not metadata:
                metadata.extend(self._scan(root))

        # metadata: (file name, slice count) a volume (fastmri.py:118-138)
        self.samples = []
        for vol_i, (fname, n_slices) in enumerate(metadata):
            if slice_index == "all":
                idxs = range(n_slices)
            elif isinstance(slice_index, (tuple, list)):
                idxs = [int(i) for i in slice_index]
            elif isinstance(slice_index, str) and "middle" in slice_index:
                i = slice_index.split("+")[-1]
                i = int(i) if "+" in slice_index and i.isdigit() else 0
                mid = n_slices // 2
                idxs = range(max(mid - i, 0), min(mid + i + 1, n_slices))
            elif slice_index == "random":
                import random

                idxs = [random.Random(vol_i).randrange(n_slices)]
            else:
                idxs = [int(slice_index)]
            self.samples += [(os.path.join(root, fname), i) for i in idxs]

    @staticmethod
    def _scan(root):
        import h5py

        files = sorted(f for f in os.listdir(root) if f.endswith(".h5"))
        if not files:
            raise FileNotFoundError(f"no fastMRI .h5 files in {root}")
        metadata = []
        for f in files:
            with h5py.File(os.path.join(root, f), "r") as fh:
                metadata.append((f, fh["kspace"].shape[0]))
        return metadata

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        import h5py

        path, sl = self.samples[i]
        with h5py.File(path, "r") as fh:
            kspace = np.asarray(fh["kspace"][sl])  # (H, W) or (N, H, W) complex
            recon_key = next((k for k in ("reconstruction_rss", "reconstruction_esc")
                              if k in fh), None)
            target = np.asarray(fh[recon_key][sl]) if recon_key else None
        y = np.stack([kspace.real, kspace.imag]).astype(np.float32)
        if target is None:  # the root-sum-of-squares of the inverse FFT
            img = _ifft2c(kspace)
            target = np.sqrt((np.abs(img) ** 2).reshape(-1, *img.shape[-2:]).sum(0))
        x = target[None].astype(np.float32)
        if self.transform is not None:
            if isinstance(self.transform, MRISliceTransform):
                return self.transform(x, y, seed=f"{os.path.basename(path)}_{sl}")
            return self.transform(x, y)
        return x, y

    def save_simple_dataset(self, dataset_path: str,
                            pad_to_size=(320, 320)) -> "SimpleFastMRISliceDataset":
        """Save the magnitude images as one ``.npy`` and return them as a
        :class:`SimpleFastMRISliceDataset` (fastmri.py:184): each rescaled to
        [0, 1], centre-cropped and zero-padded to ``pad_to_size``."""
        xs = []
        for i in range(len(self)):
            x = np.asarray(self[i][0], np.float32)  # (1, H, W) magnitude
            lo, hi = x.min(), x.max()
            x = (x - lo) / max(hi - lo, 1e-12)
            if pad_to_size is not None:
                H, W = x.shape[-2:]
                th, tw = pad_to_size
                if H > th:
                    o = (H - th) // 2
                    x = x[..., o:o + th, :]
                if W > tw:
                    o = (W - tw) // 2
                    x = x[..., :, o:o + tw]
                ph, pw = th - x.shape[-2], tw - x.shape[-1]
                if ph > 0 or pw > 0:
                    x = np.pad(x, [(0, 0)] * (x.ndim - 2)
                               + [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)])
            xs.append(x[0])
        arr = np.stack(xs).astype(np.float32)
        np.save(dataset_path, arr)
        return SimpleFastMRISliceDataset(arr)


class MRISliceTransform(MRIMixin):
    """fastMRI raw-data preprocessing (fastmri.py:219).

    * a mask from ``mask_generator``, seeded per sample where
      ``seed_mask_generator`` (the same mask for a sample at every epoch);
    * k-space normalization, by the 99th percentile of the ACS RSS image or
      to ``normalize / max |k|`` where a number is given;
    * coil noise prewhitening from a corner noise block (Cholesky);
    * low-resolution (ACS) coil maps for
      :class:`~deepinv_tpu_torch.physics.MultiCoilMRI`.

    Returns ``(x, y, params)``, params holding ``mask`` and/or ``coil_maps``
    where they are made, else ``(x, y)``.
    """

    def __init__(self, mask_generator=None, seed_mask_generator: bool = True,
                 estimate_coil_maps=False, acs: Optional[int] = None, prewhiten=False,
                 normalize=False):
        self.mask_generator = mask_generator
        self.seed_mask_generator = seed_mask_generator
        self.estimate_coil_maps = estimate_coil_maps
        self.acs = acs
        self.prewhiten = prewhiten
        if self.prewhiten is True:
            self.prewhiten = (slice(0, 30), slice(0, 30))
        self.normalize = normalize

    def get_acs(self):
        """The ACS width: ``acs``, the mask generator's ``n_center``, or an
        int ``estimate_coil_maps`` (fastmri.py:249)."""
        if self.acs is not None:
            return self.acs
        if self.mask_generator is not None and hasattr(self.mask_generator, "n_center"):
            return self.mask_generator.n_center
        if isinstance(self.estimate_coil_maps, int) and not isinstance(
                self.estimate_coil_maps, bool):
            return self.estimate_coil_maps
        raise ValueError("ACS size not specified: pass acs=, or a mask_generator with "
                         "n_center, or estimate_coil_maps=<int>.")

    @staticmethod
    def _to_complex(y):
        return y[0] + 1j * y[1]  # (..., H, W) complex

    def generate_mask(self, kspace, seed):
        """An ``(H, W)`` mask from the generator (fastmri.py:269), drawn from a
        ``torch.Generator`` on the mask generator's device seeded with the
        crc32 of ``seed`` where ``seed_mask_generator``, else from the mask
        generator's own seed."""
        gen = None
        if self.seed_mask_generator and seed is not None:
            device = getattr(self.mask_generator, "device", None) or "cpu"
            gen = torch.Generator(device=device).manual_seed(
                zlib.crc32(str(seed).encode()) & 0x7FFFFFFF)
        m = torch2cpu(self.mask_generator.step(1, generator=gen)["mask"])
        while m.ndim > 2:
            m = m[0]
        return m.astype(np.float32)

    def prewhiten_kspace(self, y):
        """Whiten the coils' noise by the Cholesky factor of its covariance in
        a corner block (fastmri.py:285)."""
        if y.ndim < 4:
            raise ValueError("kspace must be multicoil for prewhitening.")
        ksp = self._to_complex(y)  # (N, H, W)
        n = ksp[:, self.prewhiten[0], self.prewhiten[1]].reshape(ksp.shape[0], -1)
        n = n - n.mean(axis=-1, keepdims=True)
        cov = (n @ n.conj().T) / n.shape[-1]
        L = np.linalg.cholesky(cov + 1e-12 * np.eye(cov.shape[0]))
        white = np.linalg.solve(L, ksp.reshape(ksp.shape[0], -1)).reshape(ksp.shape)
        return np.stack([white.real, white.imag]).astype(np.float32)

    def _acs_block(self, ksp, acs):
        W = ksp.shape[-1]
        cw = slice(W // 2 - acs // 2, W // 2 + (acs + 1) // 2)
        block = np.zeros_like(ksp)
        block[..., cw] = ksp[..., cw]
        return block

    def normalize_kspace(self, y):
        """``(y / scale, scale)`` (fastmri.py:305)."""
        ksp = self._to_complex(y)
        if self.normalize is True:
            lowres = _ifft2c(self._acs_block(ksp, self.get_acs()))
            rss = np.sqrt((np.abs(lowres) ** 2).reshape(-1, *lowres.shape[-2:]).sum(0))
            scale = np.percentile(rss, 99)
        else:
            scale = np.abs(ksp).max() / float(self.normalize)
        return (y / max(scale, 1e-12)).astype(np.float32), scale

    def generate_maps(self, y):
        """Low-res (ACS) coil maps ``(N, H, W)`` complex: the coil images of
        the central k-space block over their RSS (fastmri.py:324)."""
        ksp = self._to_complex(y)  # (N, H, W)
        if ksp.ndim != 3:
            raise ValueError("coil maps need multicoil kspace (2, N, H, W)")
        lowres = _ifft2c(self._acs_block(ksp, self.get_acs()))
        rss = np.sqrt((np.abs(lowres) ** 2).sum(0, keepdims=True))
        return (lowres / np.clip(rss, 1e-12, None)).astype(np.complex64)

    def __call__(self, x, y, seed=None):
        params = {}
        if self.prewhiten:
            y = self.prewhiten_kspace(y)
        if self.normalize:
            y, scale = self.normalize_kspace(y)
            x = (x / max(scale, 1e-12)).astype(np.float32)
        if self.estimate_coil_maps:
            params["coil_maps"] = self.generate_maps(y)
        if self.mask_generator is not None:
            mask = self.generate_mask(y, seed)
            params["mask"] = mask
            y = (y * mask).astype(np.float32)
        if params:
            return x, y, params
        return x, y


class SimpleFastMRISliceDataset(ImageDataset):
    """In-memory magnitude images (fastmri.py:360), served as 2-channel
    images with a zero imaginary part, ready for the MRI physics."""

    def __init__(self, root_or_images, train: bool = True, transform=None):
        if isinstance(root_or_images, (list, tuple, np.ndarray)):
            imgs = np.asarray(root_or_images, np.float32)
        else:
            imgs = np.load(root_or_images)
        if imgs.ndim == 3:
            imgs = imgs[:, None]
        self.x = imgs.astype(np.float32)
        self.transform = transform

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        x = self.x[i]
        if x.shape[0] == 1:
            x = np.concatenate([x, np.zeros_like(x)], axis=0)
        if self.transform is not None:
            x = self.transform(x)
        return x

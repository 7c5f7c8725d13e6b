"""CMRxRecon and SKM-TEA slice datasets (port of
deepinv_tpu/datasets/mri_slices.py).

* **CMRxRecon 2023** (dynamic cardiac cine MRI): MATLAB 7.3 ``.mat`` volumes
  of fully sampled k-space under
  ``SingleCoil/Cine/TrainingSet/FullSample/PXXX/cine_{lax,sax}.mat``, with the
  acceleration masks in sibling ``AccFactorXX`` trees (``*_mask.mat``). Items
  are ``(x, y, params)`` with 2-D+t images ``(2, T, W, H)`` for
  :class:`~deepinv_tpu_torch.physics.DynamicMRI`.
* **SKM-TEA** (quantitative knee MRI): ``.h5`` files of ``kspace``
  ``(slice, H, W, E, N)``, the SENSE ``target`` ``(slice, H, W, E, 1)``,
  JSENSE ``maps`` and the elliptical Poisson-disc ``masks/poisson_<acc>x``.
  Items are ``(x, y, params)`` for
  :class:`~deepinv_tpu_torch.physics.MultiCoilMRI`.

Items are numpy arrays, as the JAX package's. The CMRxRecon target's k-space
goes through the port's :class:`~deepinv_tpu_torch.physics.mri.MRIMixin`
FFTs (on the host), and its noise draws from a ``torch.Generator`` seeded
with the crc32 of the sample's name where the JAX package seeds a key.
"""

from __future__ import annotations

import os
import re
import warnings
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ..physics.mri import MRIMixin
from ..utils import torch2cpu
from ..utils.io import load_mat
from .fastmri import FastMRISliceDataset, MRISliceTransform

__all__ = ["CMRxReconSliceDataset", "SKMTEASliceDataset"]


def natsorted(items):
    """Natural (numeric-aware) sort (mri_slices.py:39)."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def _rglob(root, suffix):
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(suffix)]
    return natsorted(out)


class CMRxReconSliceDataset(FastMRISliceDataset, MRIMixin):
    """CMRxRecon 2023 dynamic-MRI slices (mri_slices.py:61).

    Walks ``root/data_dir`` for the ``cine_*.mat`` MATLAB 7.3 volumes of
    shape ``WH(N)DT`` (width, height, [coils,] slices, time); an item is one
    slice as ``(x, y, params)``:

    * ``x``: the normalized 2-D+t image ``(2, T, W, H)``;
    * ``y``: the masked k-space of ``x``, the same shape;
    * ``params["mask"]``: the acceleration mask, from ``mask_dir``
      (``*_mask.mat``) or drawn by ``mask_generator``.

    :param root: the archive's root.
    :param data_dir: the fully sampled data's subdirectory.
    :param apply_mask: mask the k-space (else ``(x, y)`` fully sampled).
    :param mask_dir: the masks' subdirectory.
    :param mask_generator: a mask a sample (exclusive with ``mask_dir``).
    :param transform: applied to the target before padding.
    :param pad_size: ``(W, H)`` the target and mask are zero-padded to.
    :param noise_model: a k-space noise model of the port.
    """

    def __init__(self, root: str, data_dir: str = "SingleCoil/Cine/TrainingSet/FullSample",
                 load_metadata_from_cache: bool = False, save_metadata_to_cache: bool = False,
                 metadata_cache_file: str = "dataset_cache.pkl", apply_mask: bool = True,
                 mask_dir: Optional[str] = "SingleCoil/Cine/TrainingSet/AccFactor04",
                 mask_generator=None, transform: Optional[Callable] = None,
                 pad_size=(512, 256), noise_model=None):
        self.root = str(root)
        self.data_dir = data_dir
        self.mask_dir = mask_dir
        self.transform = transform
        self.mask_generator = mask_generator
        self.apply_mask = apply_mask
        self.load_metadata_from_cache = load_metadata_from_cache
        self.save_metadata_to_cache = save_metadata_to_cache
        self.metadata_cache_file = metadata_cache_file
        self.pad_size = pad_size
        self.noise_model = noise_model

        if not self.apply_mask and (self.mask_generator is not None
                                    or self.mask_dir is not None):
            warnings.warn("mask_generator or mask_dir specified but apply_mask is False; they "
                          "will not be used.")
            self.mask_dir = self.mask_generator = None
        if self.apply_mask and self.mask_generator is not None and self.mask_dir is not None:
            raise ValueError("Only one of mask_generator or mask_dir should be specified.")

        data_root = os.path.join(self.root, self.data_dir)
        if not os.path.isdir(data_root) or (
                self.mask_dir is not None
                and not os.path.isdir(os.path.join(self.root, self.mask_dir))):
            raise ValueError("Data or mask folder does not exist; set root, data_dir and "
                             "mask_dir properly.")

        all_fnames = [f for f in _rglob(data_root, ".mat") if not f.endswith("_mask.mat")]
        with self.metadata_cache_manager(self.root, []) as samples:
            if len(samples) == 0:
                for fname in all_fnames:
                    metadata = self._retrieve_metadata(fname)
                    for slice_ind in range(metadata["num_slices"]):
                        samples.append(self.SliceSampleID(fname, slice_ind, metadata))
            self.samples = samples

    @staticmethod
    def _loadmat(fname) -> np.ndarray:
        """The first array of a MATLAB 7.3 file (mri_slices.py:155)."""
        return next(v for k, v in load_mat(fname, mat73=True).items() if not k.startswith("__"))

    def _retrieve_metadata(self, fname) -> dict:
        """Width, height, slices and time frames (and coils) from the
        ``WH(N)DT`` shape (mri_slices.py:164)."""
        shape = self._loadmat(fname).shape
        md = {"width": shape[0], "height": shape[1], "num_slices": shape[-2],
              "timeframes": shape[-1]}
        if len(shape) == 5:
            md["coils"] = shape[2]
        return md

    def __len__(self):
        return len(self.samples)

    def _noise(self, kspace, name: str) -> np.ndarray:
        """``noise_model`` of ``kspace`` on the model's device, drawn from a
        generator seeded with the crc32 of ``name`` (mri_slices.py:235)."""
        device = next((t.device for t in self.noise_model.buffers()), torch.device("cpu"))
        gen = torch.Generator(device=device).manual_seed(zlib.crc32(name.encode()) & 0x7FFFFFFF)
        return torch2cpu(self.noise_model(torch.from_numpy(kspace).to(device), generator=gen))

    def __getitem__(self, i):
        fname, slice_ind, metadata = self.samples[i]

        kspace = self._loadmat(fname)[..., slice_ind, :]  # WH(N)T
        if kspace.ndim == 4:
            kspace = kspace[:, :, 0]  # the first coil, WHT
        kspace = np.stack([kspace.real, kspace.imag], axis=0)  # (2, W, H, T)
        kspace = np.moveaxis(kspace, -1, 1).astype(np.float32)  # (2, T, W, H)

        if self.apply_mask:
            if self.mask_generator is None:
                mpath = fname.replace(os.path.normpath(self.data_dir),
                                      os.path.normpath(self.mask_dir)).replace(".mat",
                                                                               "_mask.mat")
                if not os.path.exists(mpath):
                    raise FileNotFoundError("Mask not found in mask_dir and mask_generator not "
                                            "specified.")
                mask = self._loadmat(mpath)  # (T, W, H) or (W, H)
                mask = torch2cpu(self.check_mask(mask, three_d=True)[0]).astype(np.float32)
            else:
                mask = MRISliceTransform(mask_generator=self.mask_generator).generate_mask(
                    kspace, str(fname) + str(slice_ind))
            mask = np.broadcast_to(mask, kspace.shape).astype(np.float32)
        else:
            mask = np.ones_like(kspace)

        # the target from the fully sampled k-space
        target = torch2cpu(self.kspace_to_im(torch.from_numpy(kspace[None]))[0]).astype(np.float32)
        if self.transform is not None:
            target = self.transform(target)
        if self.pad_size is not None:
            w = self.pad_size[0] - target.shape[-2]
            h = self.pad_size[1] - target.shape[-1]
            pad = [(0, 0)] * (target.ndim - 2) + [(w // 2, w // 2), (h // 2, h // 2)]
            target = np.pad(target, pad)
            mask = np.pad(mask, pad)

        target = (target - target.mean()) / (target.std() + 1e-11)
        kspace = torch2cpu(self.im_to_kspace(torch.from_numpy(target[None]))[0]).astype(np.float32)
        if self.noise_model is not None:
            kspace = self._noise(kspace, f"{fname}{slice_ind}").astype(np.float32) * mask

        if self.apply_mask:
            return target, (kspace * mask).astype(np.float32), {"mask": mask}
        return target, kspace.astype(np.float32)


class SKMTEASliceDataset(FastMRISliceDataset, MRIMixin):
    """SKM-TEA raw multi-coil k-space slices (mri_slices.py:252).

    Items are ``(x, y, params)``: the SENSE target ``(2, H, W)``, the
    undersampled k-space ``(2, N, H, W)`` and ``params = {"mask",
    "coil_maps"}``, the archive's Poisson-disc mask zero-padded to the
    k-space's shape and the JSENSE maps ``(N, H, W)`` complex.

    :param root: directory of SKM-TEA ``.h5`` files.
    :param echo: the qDESS echo, 0 or 1.
    :param acc: the mask's acceleration: 4, 6, 8, 10, 12 or 16.
    :param filter_id: a predicate on ``SliceSampleID``.
    """

    def __init__(self, root: str, echo: int = 0, acc: int = 6,
                 load_metadata_from_cache: bool = False, save_metadata_to_cache: bool = False,
                 metadata_cache_file: str = "skmtea_dataset_cache.pkl",
                 filter_id: Optional[Callable] = None):
        self.root = str(root)
        self.echo = echo
        self.acc = acc
        self.load_metadata_from_cache = load_metadata_from_cache
        self.save_metadata_to_cache = save_metadata_to_cache
        self.metadata_cache_file = metadata_cache_file

        all_fnames = _rglob(self.root, ".h5")
        with self.metadata_cache_manager(self.root, []) as samples:
            if len(samples) == 0:
                for fname in all_fnames:
                    metadata = self._retrieve_metadata(fname)
                    for slice_ind in range(metadata["num_slices"]):
                        samples.append(self.SliceSampleID(fname, slice_ind, metadata))
            self.samples = samples
        if filter_id is not None:
            self.samples = list(filter(filter_id, self.samples))

    @staticmethod
    def _retrieve_metadata(fname) -> dict:
        """The k-space dims ``(slice, H, W, E, N)`` (mri_slices.py:300)."""
        import h5py

        with h5py.File(fname, "r") as hf:
            shape = hf["kspace"].shape
            return {"num_slices": shape[0], "height": shape[1], "width": shape[2],
                    "echos": shape[3], "coils": shape[4]}

    @staticmethod
    def zero_pad(x: np.ndarray, shape, mode="constant", value=0) -> np.ndarray:
        """Centre zero-pad dims 1..len(shape) of ``x`` to ``shape``; ``None``
        keeps a dim (mri_slices.py:315)."""
        pad = [(0, 0)]
        for current, desired in zip(x.shape[1:1 + len(shape)], shape):
            total = 0 if desired is None else desired - current
            pad.append((total // 2, total - total // 2))
        pad += [(0, 0)] * (x.ndim - len(pad))
        kw = {"constant_values": value} if mode == "constant" else {}
        return np.pad(x, pad, mode=mode, **kw)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        import h5py

        fname, slice_ind, metadata = self.samples[idx]
        with h5py.File(fname, "r") as f:
            x = np.asarray(f["target"][slice_ind, :, :, self.echo, 0])
            y = np.asarray(f["kspace"][slice_ind, :, :, self.echo, :])
            mask = np.asarray(f[f"masks/poisson_{self.acc}.0x"])
            maps = np.asarray(f["maps"][slice_ind, :, :, :, 0])

        # (h, w) bool -> (1, H, W) float, padded to the k-space's shape
        mask = self.zero_pad(mask[None].astype(np.float32), y.shape[:2])
        y = np.moveaxis(y, -1, 0)  # (H, W, N) -> (N, H, W) complex
        y = np.stack([y.real, y.imag], axis=0).astype(np.float32) * mask[None]
        x = np.stack([x.real, x.imag], axis=0).astype(np.float32)  # (2, H, W)
        maps = np.moveaxis(maps, -1, 0).astype(np.complex64)  # (N, H, W)
        return x, y, {"mask": mask, "coil_maps": maps}

"""File readers (port of deepinv_tpu/utils/io.py).

numpy arrays from ``.npy``, MATLAB ``.mat`` (v7.3 through ``h5py``), TIFF and
other rasters (PIL), DICOM (:mod:`deepinv_tpu_torch.utils.dicom`), NIfTI-1
(a reader in numpy) and ISMRMRD/fastMRI HDF5 files. Each optional package is
imported where a file is read, so that importing the module needs none of
them. Nothing is downloaded: the URL readers raise :class:`DownloadError`.
"""

from __future__ import annotations

import gzip
import math
import os
import struct

import numpy as np

from .dicom import load_dicom

__all__ = ["DownloadError", "load_np", "load_mat", "load_tiff", "load_dicom", "load_nifti",
           "load_ismrmd", "load_raster", "load_url", "load_example", "get_cache_home",
           "get_data_home"]


class DownloadError(RuntimeError):
    """Raised where remote content would have to be fetched (io.py:25)."""


def get_cache_home() -> str:
    """``DEEPINV_CACHE_DIR``, else ``~/.cache/deepinv_tpu`` (io.py:29)."""
    return os.environ.get(
        "DEEPINV_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "deepinv_tpu"))


def get_data_home() -> str:
    return os.path.join(get_cache_home(), "datasets")


def load_np(path):
    return np.load(path)


def load_mat(path, mat73: bool = False) -> dict:
    """A MATLAB ``.mat`` file as a dict of numpy arrays (io.py:43). With
    ``mat73=True``, or where scipy refuses a v7.3 file, the HDF5 file is read
    with ``h5py``: each array's axes back in MATLAB's order and ``real``/
    ``imag`` compounds as complex arrays, as the ``mat73`` package gives
    them."""
    if not mat73:
        from scipy.io import loadmat

        try:
            return loadmat(path)
        except NotImplementedError:
            pass  # a v7.3 file: read it as HDF5
    import h5py

    def convert(ds):
        a = np.asarray(ds)
        if a.dtype.names and {"real", "imag"} <= set(a.dtype.names):
            a = a["real"] + 1j * a["imag"]
        return a.transpose(range(a.ndim - 1, -1, -1)) if a.ndim > 1 else a

    out = {}
    with h5py.File(path, "r") as f:
        for k, v in f.items():
            if k != "#refs#" and isinstance(v, h5py.Dataset):
                out[k] = convert(v)
    return out


def load_tiff(path):
    """A TIFF file's pixels as numpy, through PIL (io.py:76)."""
    from PIL import Image

    return np.asarray(Image.open(path))


# NIfTI-1 datatype code -> numpy dtype (nifti1.h)
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 32: np.complex64,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64, 1792: np.complex128,
}


def load_nifti(path, as_memmap: bool = False, dtype=np.float32, **kwargs):
    """A NIfTI-1 volume (io.py:103): the 348-byte header's dims, datatype,
    ``vox_offset`` and ``scl_slope``/``scl_inter``, the voxels in Fortran
    order from ``vox_offset``; ``.nii`` or ``.nii.gz``, either byte order.
    ``as_memmap`` maps the raw voxels of an uncompressed file."""
    p = str(path)
    opener = gzip.open if p.endswith(".gz") else open
    with opener(p, "rb") as f:
        hdr = f.read(352)
        (size,) = struct.unpack("<i", hdr[:4])
        bo = "<" if size == 348 else ">"
        if struct.unpack(bo + "i", hdr[:4])[0] != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr != 348)")
        dim = struct.unpack(bo + "8h", hdr[40:56])
        (dtcode,) = struct.unpack(bo + "h", hdr[70:72])
        (vox_offset,) = struct.unpack(bo + "f", hdr[108:112])
        scl_slope, scl_inter = struct.unpack(bo + "2f", hdr[112:120])
        shape = tuple(int(d) for d in dim[1:1 + max(dim[0], 1)])
        raw_dt = np.dtype(_NIFTI_DTYPES[dtcode]).newbyteorder(bo)
        count = int(np.prod(shape))
        off = int(vox_offset) if vox_offset else 352
        if as_memmap and opener is open:
            return np.memmap(p, dtype=raw_dt, mode="r", offset=off, shape=shape, order="F")
        f.seek(off)
        a = np.frombuffer(f.read(count * raw_dt.itemsize), dtype=raw_dt)
    a = a.reshape(shape, order="F")
    # a NaN slope or intercept is unset; a zero slope means no scaling at all
    if math.isnan(scl_slope):
        scl_slope = 0.0
    if math.isnan(scl_inter):
        scl_inter = 0.0
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        a = a * scl_slope + scl_inter
    return a.astype(dtype) if dtype is not None else a


def load_ismrmd(path, data_name: str = "kspace", data_slice=None, **kwargs):
    """Complex MRI data of an ISMRMRD/fastMRI HDF5 file (io.py:151), its
    real and imaginary parts on a new leading axis ``(2, ...)``;
    ``data_slice`` is applied before the read, so only that slab is read."""
    import h5py

    with h5py.File(path, "r") as f:
        if data_name in f:
            ds = f[data_name]
        else:  # ISMRMRD nests its datasets in groups
            found = []
            f.visititems(lambda n, o: found.append(o) if isinstance(o, h5py.Dataset)
                         and n.split("/")[-1] == data_name else None)
            if not found:
                raise KeyError(f"{data_name!r} not found in {path}")
            ds = found[0]
        a = np.asarray(ds[data_slice] if data_slice is not None else ds[()])
    if np.iscomplexobj(a):
        return np.stack([a.real, a.imag], 0)
    return a


def load_raster(path, patch=False, patch_start=(0, 0), transform=None, **kwargs):
    """A raster image as ``(C, H, W)``, or its patches (io.py:176), through
    PIL. ``patch=int | (h, w)`` yields row-major ``(C, h, w)`` patches from
    ``patch_start``; ``patch=True`` (the file's own block windows) needs
    rasterio and raises."""
    from PIL import Image

    a = np.asarray(Image.open(path))
    a = a[None] if a.ndim == 2 else np.moveaxis(a, -1, 0)
    if patch is False:
        return a if transform is None else transform(a)
    if patch is True:
        raise NotImplementedError(
            "patch=True streams the raster's internal block windows, which requires rasterio; "
            "pass an explicit patch size instead")
    ph, pw = (patch, patch) if isinstance(patch, int) else patch
    h0, w0 = patch_start

    def gen():
        for i in range(h0, a.shape[1] - ph + 1, ph):
            for j in range(w0, a.shape[2] - pw + 1, pw):
                p = a[:, i:i + ph, j:j + pw]
                yield p if transform is None else transform(p)

    return gen()


def load_url(url, **kwargs):
    """Raises :class:`DownloadError`: the port fetches nothing (io.py:209)."""
    raise DownloadError(f"cannot fetch {url}: the port downloads nothing. Place the file "
                        "locally and use the load_* functions.")


def load_example(name, **kwargs):
    """A synthetic stand-in for a named example (io.py:216): the Shepp-Logan
    phantom for a CT or Shepp-Logan name, random circles for a circles name;
    any other name would need a download and raises."""
    from ..datasets.phantoms import random_circles, shepp_logan

    if "shepp" in name.lower() or "ct" in name.lower():
        return shepp_logan(kwargs.get("size", 128))[None, None]
    if "circle" in name.lower():
        return random_circles(kwargs.get("size", 64), seed=kwargs.get("seed", 0))[None]
    raise DownloadError(f"example {name!r} requires a download, which the port does not make")

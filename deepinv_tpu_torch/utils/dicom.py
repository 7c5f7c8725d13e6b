"""A DICOM reader in numpy (port of deepinv_tpu/utils/dicom.py).

Reads uncompressed monochrome slices in Explicit VR Little Endian, the
transfer syntax of LIDC-IDRI's CT slices, and the few tags a CT pipeline
needs (Rows, Columns, BitsAllocated, PixelRepresentation,
RescaleSlope/Intercept). ``pydicom`` is used instead where it is installed,
imported where a file is read.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["load_dicom"]

# (group, element) -> name for the tags we care about
_TAGS = {
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x0020, 0x0013): "InstanceNumber",
    (0x7FE0, 0x0010): "PixelData",
}

# VRs with a 2-byte reserved field + 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}


def _parse_elements(buf, offset):
    """Yield (tag, vr, value_bytes) for explicit-VR little-endian data."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, offset)
        vr = buf[offset + 4 : offset + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", buf, offset + 8)
            value_off = offset + 12
        elif vr.isalpha() and vr.isupper():
            (length,) = struct.unpack_from("<H", buf, offset + 6)
            value_off = offset + 8
        else:
            # implicit VR element (no ascii VR): 4-byte length
            (length,) = struct.unpack_from("<I", buf, offset + 4)
            vr = b"UN"
            value_off = offset + 8
        if length == 0xFFFFFFFF:
            raise ValueError("undefined-length DICOM elements not supported")
        yield (group, elem), vr, buf[value_off : value_off + length]
        offset = value_off + length


def load_dicom(path, as_tensor: bool = False, apply_rescale: bool = False, dtype=None,
               device=None):
    """One uncompressed DICOM slice as an ``(H, W)`` numpy array
    (dicom.py:57).

    :param apply_rescale: apply ``slope * raw + intercept`` (Hounsfield units
        for CT), as float32.
    :param dtype: cast the raw pixel array (ignored with ``apply_rescale``).
    :param as_tensor: return a tensor on ``device`` (the CUDA device where it
        is None, :func:`~deepinv_tpu_torch.device.resolve_device`).
    """
    try:  # pydicom where it is installed
        import pydicom

        ds = pydicom.dcmread(path)
        arr = ds.pixel_array
        meta = {
            "RescaleSlope": float(getattr(ds, "RescaleSlope", 1.0)),
            "RescaleIntercept": float(getattr(ds, "RescaleIntercept", 0.0)),
        }
    except ImportError:
        with open(path, "rb") as f:
            buf = f.read()
        if buf[128:132] != b"DICM":
            raise ValueError(f"{path}: not a DICOM part-10 file")
        meta = {"RescaleSlope": 1.0, "RescaleIntercept": 0.0,
                "PixelRepresentation": 0, "BitsAllocated": 16}
        pixel_data = None
        for tag, vr, val in _parse_elements(buf, 132):
            name = _TAGS.get(tag)
            if name is None:
                continue
            if name == "PixelData":
                pixel_data = val
            elif vr == b"US":
                meta[name] = struct.unpack("<H", val[:2])[0]
            elif vr in (b"DS", b"IS"):
                try:
                    meta[name] = float(val.decode("ascii").strip("\x00 "))
                except ValueError:
                    pass
        if pixel_data is None:
            raise ValueError(f"{path}: no PixelData element")
        bits = meta.get("BitsAllocated", 16)
        signed = meta.get("PixelRepresentation", 0) == 1
        np_dtype = {8: np.uint8, 16: np.int16 if signed else np.uint16}[bits]
        arr = np.frombuffer(pixel_data, dtype=np_dtype)
        rows, cols = meta.get("Rows"), meta.get("Columns")
        if rows and cols:
            arr = arr[: rows * cols].reshape(rows, cols)

    if apply_rescale:
        arr = (meta["RescaleSlope"] * arr.astype(np.float32)
               + meta["RescaleIntercept"]).astype(np.float32)
    elif dtype is not None:
        arr = arr.astype(dtype)
    if as_tensor:
        import torch

        from ..device import resolve_device

        return torch.from_numpy(np.array(arr)).to(resolve_device(device))
    return arr

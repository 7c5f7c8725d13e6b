"""Dataset file helpers (port of deepinv_tpu/datasets/utils.py): the MD5
of a file or a folder, with which the named datasets check their files, and
the extraction of local zip and tar archives. Nothing here downloads."""

from __future__ import annotations

import hashlib
import os
import tarfile
import zipfile

from .base import check_dataset

__all__ = [
    "calculate_md5",
    "calculate_md5_for_folder",
    "check_path_is_a_folder",
    "extract_zipfile",
    "extract_tarball",
    "check_dataset",
]


def check_path_is_a_folder(folder_path: str) -> bool:
    """True iff ``folder_path`` exists and strictly contains files
    (utils.py:28)."""
    if not os.path.isdir(folder_path):
        return False
    entries = [os.path.join(folder_path, f) for f in os.listdir(folder_path)]
    return bool(entries) and all(os.path.isfile(p) for p in entries)


def calculate_md5(fpath: str, chunk_size: int = 1024 * 1024) -> str:
    """MD5 of one file, streamed (utils.py:37)."""
    md5 = hashlib.md5()
    with open(fpath, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            md5.update(chunk)
    return md5.hexdigest()


def calculate_md5_for_folder(folder_path: str) -> str:
    """MD5 over the sorted per-file MD5s of a flat folder (utils.py:49). A
    folder holding anything but files hashes as empty."""
    md5_folder = hashlib.md5()
    if check_path_is_a_folder(folder_path):
        for filename in sorted(os.listdir(folder_path)):
            md5_folder.update(
                calculate_md5(os.path.join(folder_path, filename)).encode()
            )
    return md5_folder.hexdigest()


def extract_zipfile(file_path, extract_dir) -> None:
    """Extract a local zip archive (utils.py:62)."""
    with zipfile.ZipFile(file_path, "r") as z:
        z.extractall(extract_dir)


def extract_tarball(file_path, extract_dir) -> None:
    """Extract a local tarball, any compression (utils.py:68)."""
    with tarfile.open(file_path, "r:*") as t:
        # the 'data' filter refuses absolute paths and links leaving extract_dir
        t.extractall(extract_dir, filter="data")

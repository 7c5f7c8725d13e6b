"""The native host image decoder (port of deepinv_tpu/native/).

A small C++ library (``src/imageio.cpp``, the port's own copy of the JAX
package's source) decodes PNG and JPEG files with libpng and libjpeg and
assembles float32 NCHW batches on C++ threads: no worker processes, no
pickling, the GIL released for the whole decode. It writes into a
caller-owned buffer; :class:`NativePrefetcher` makes that buffer a torch
tensor in pinned memory when the batches go to a CUDA device, so one
asynchronous copy ships each batch.

The library is built with the system ``g++`` at first use into
``deepinv_tpu_torch/_build/`` (named by a digest of the source, written
atomically, so concurrent processes may build it at once) and loaded with
``ctypes``. It is a host decoder, not a device kernel: where it does not build
(no compiler, no libpng or libjpeg headers), :func:`native_available` is
False, ``ImageFolder(backend="auto")`` decodes with PIL and
``backend="native"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["native_available", "probe_image", "decode_image", "decode_batch",
           "NativePrefetcher"]

_SRC = Path(__file__).resolve().parent / "src" / "imageio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lpng", "-ljpeg", "-lpthread"]
_lock = threading.Lock()
_state = {"lib": None, "error": None}
_FLOATS = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the decoder of this source and these flags is (or will be) built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libdeepinv_imageio-{h.hexdigest()[:16]}.so"


def _build(so: Path):
    """Compile the decoder to ``so``; returns the compiler's complaint or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / "lib.so"
        try:
            r = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS],
                               capture_output=True, text=True, timeout=180)
        except (OSError, subprocess.TimeoutExpired) as e:  # no g++, or it hung
            return str(e)
        if r.returncode != 0:
            return r.stderr[-2000:]
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_str, c_ptr = ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p
    ints = ctypes.POINTER(c_int)
    lib.dtpu_decode.argtypes = [c_str, _FLOATS, c_int, c_int, c_int, c_int]
    lib.dtpu_decode.restype = c_int
    lib.dtpu_probe.argtypes = [c_str, ints, ints, ints]
    lib.dtpu_probe.restype = c_int
    lib.dtpu_decode_batch.argtypes = [ctypes.POINTER(c_str), c_int, _FLOATS, c_int, c_int, c_int,
                                      c_int, c_int]
    lib.dtpu_decode_batch.restype = c_int
    lib.dtpu_prefetcher_new.argtypes = [ctypes.POINTER(c_str), c_int, c_int, c_int, c_int, c_int,
                                        c_int, c_int]
    lib.dtpu_prefetcher_new.restype = c_ptr
    lib.dtpu_prefetcher_get.argtypes = [c_ptr, c_int, _FLOATS]
    lib.dtpu_prefetcher_get.restype = c_int
    lib.dtpu_prefetcher_free.argtypes = [c_ptr]
    lib.dtpu_prefetcher_free.restype = None
    return lib


def _load():
    """The loaded library, built first if need be; None where it cannot be
    (the reason in ``_state["error"]``). Tried once a process."""
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            so = library_path()
            err = None if so.exists() else _build(so)
            if err is None:
                try:
                    _state["lib"] = _declare(ctypes.CDLL(str(so)))
                except OSError as e:
                    err = str(e)
            _state["error"] = err
        return _state["lib"]


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_state['error']}")
    return lib


def native_available() -> bool:
    """True if the C++ decoder built and loaded on this machine."""
    return _load() is not None


def _mode(mode: str) -> int:
    if mode not in ("resize", "crop"):
        raise ValueError(f"mode must be 'resize' or 'crop', got {mode!r}")
    return 1 if mode == "crop" else 0


def probe_image(path: str):
    """``(H, W, C)`` of an image file, read by the native decoder."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if _lib().dtpu_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)):
        raise IOError(f"cannot decode {path}")
    return h.value, w.value, c.value


def decode_image(path: str, shape=(3, 256, 256), mode: str = "resize") -> np.ndarray:
    """One PNG or JPEG as a float32 ``(C, H, W)`` array in [0, 1]
    (native/__init__.py:119).

    :param mode: ``"resize"`` (bilinear to ``shape``) or ``"crop"`` (center
        crop).
    """
    C, H, W = shape
    out = np.empty((C, H, W), np.float32)
    if _lib().dtpu_decode(str(path).encode(), out.ctypes.data_as(_FLOATS), C, H, W, _mode(mode)):
        raise IOError(f"cannot decode {path}")
    return out


def decode_batch(paths, shape=(3, 256, 256), mode: str = "resize",
                 n_threads: int = 0) -> np.ndarray:
    """N images decoded in parallel into a float32 ``(N, C, H, W)`` batch
    (native/__init__.py:138); ``n_threads`` 0 means one a core."""
    C, H, W = shape
    n = len(paths)
    out = np.empty((n, C, H, W), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    fails = _lib().dtpu_decode_batch(arr, n, out.ctypes.data_as(_FLOATS), C, H, W, _mode(mode),
                                     n_threads)
    if fails:
        raise IOError(f"{fails}/{n} images failed to decode")
    return out


class NativePrefetcher:
    """Double-buffered background batch loader over image paths
    (native/__init__.py:157): batch ``k + 1`` decodes on C++ threads while
    the caller consumes batch ``k``.

    :param paths: the image files, in batch order.
    :param batch_size: images a batch (the last may be short).
    :param shape: ``(C, H, W)`` of each image.
    :param device: where the batches go, the CUDA device by default; the
        host buffer is pinned when it is a CUDA device, and the copy is
        asynchronous.

    ``get(k, out=None)`` writes batch ``k`` into ``out`` (a contiguous
    float32 CPU tensor of ``(batch_size, C, H, W)`` that the caller owns) or
    into a fresh buffer, and returns its valid images on ``device``. The
    copy to a CUDA device is asynchronous; a CUDA event recorded after it
    is waited on before the decoder writes into the same ``out`` again, so
    a caller may pass one pinned buffer for every batch.
    """

    def __init__(self, paths, batch_size: int, shape=(3, 256, 256), mode: str = "resize",
                 n_threads: int = 0, device=None):
        from ..device import resolve_device

        self._lib = _lib()
        self.device = resolve_device(device)
        self.paths = [str(p) for p in paths]
        self.batch_size = batch_size
        self.shape = tuple(shape)
        self.n_batches = -(-len(self.paths) // batch_size)
        self._paths_c = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        C, H, W = self.shape
        self._h = self._lib.dtpu_prefetcher_new(self._paths_c, len(self.paths), C, H, W,
                                                _mode(mode), batch_size, n_threads)
        self._copies = {}   # a caller's buffer's address -> the event after its last copy

    def get(self, batch_idx: int, out: torch.Tensor = None) -> torch.Tensor:
        caller_owned = out is not None
        if out is None:
            out = torch.empty((self.batch_size,) + self.shape, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
        if (out.device.type != "cpu" or out.dtype != torch.float32 or not out.is_contiguous()
                or tuple(out.shape) != (self.batch_size,) + self.shape):
            raise ValueError(f"out must be a contiguous float32 CPU tensor of "
                             f"{(self.batch_size,) + self.shape}")
        pending = self._copies.pop(out.data_ptr(), None)
        if pending is not None:
            pending.synchronize()
        count = self._lib.dtpu_prefetcher_get(self._h, batch_idx,
                                              ctypes.cast(out.data_ptr(), _FLOATS))
        batch = out[:count].to(self.device, non_blocking=True)
        if self.device.type == "cuda" and caller_owned:
            done = torch.cuda.Event()
            done.record()
            self._copies[out.data_ptr()] = done
        return batch

    def __iter__(self):
        for i in range(self.n_batches):
            yield self.get(i)

    def __len__(self):
        return self.n_batches

    def close(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dtpu_prefetcher_free(h)

    def __del__(self):
        self.close()

"""Build and load the port's CUDA kernels.

The sources are ``deepinv_tpu_torch/csrc/*.cu`` and ``*.cuh``. On first use
each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (all at once), and the
objects are linked into one shared library with a plain C interface, named by
a hash of the sources and the flags, under
``deepinv_tpu_torch/_build/``, and loaded with ``ctypes``. A later process with
the same sources loads the library it finds there. Nothing is built when a
module is imported: :func:`load_library` runs inside the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "build_log"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                           "build the deepinv_tpu_torch CUDA kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.deepinv_resblock_chain_bf16.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.deepinv_resblock_chain_bf16.restype = i
    lib.deepinv_conv_chain_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.deepinv_conv_chain_bf16.restype = i
    lib.deepinv_cuda_error_string.argtypes = [i]
    lib.deepinv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds, log):
    """Run the commands side by side; log each one's output; raise on the
    first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        log.append(" ".join(cmd) + "\n" + out)
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc={p.returncode}):\n{out[-4000:]}")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile the kernels if this set of sources has not been built yet,
    then load the library (once per process). Each ``.cu`` file is compiled
    by its own ``nvcc``, all started together, and the objects are linked
    into one library."""
    so = BUILD_DIR / f"libdeepinv_kernels-{_digest()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = []
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            cu = [s for s in _sources() if s.suffix == ".cu"]
            objs = [str(Path(tmpdir) / f"{s.stem}.o") for s in cu]
            compiles = [[_nvcc(), *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", o, str(s)]
                        for s, o in zip(cu, objs)]
            tmp = str(Path(tmpdir) / "lib.so")
            try:
                _run_all(compiles, log)
                _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]], log)
            finally:
                (BUILD_DIR / "build.log").write_text("\n".join(log))
            os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return _declare(ctypes.CDLL(str(so)))


def build_log() -> str:
    """The compiler's output from the last build in this checkout (register
    and shared-memory use per kernel, from ``-Xptxas -v``)."""
    log = BUILD_DIR / "build.log"
    return log.read_text() if log.exists() else ""

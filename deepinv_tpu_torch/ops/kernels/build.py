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

__all__ = ["load_library", "build_log", "library_path", "cuda_tool"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def cuda_tool(name: str) -> str:
    """Path of the CUDA toolkit's program ``name`` (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: set CUDA_HOME or put the CUDA toolkit's bin "
                           "on PATH to build the deepinv_tpu_torch CUDA kernels")
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
    lib.deepinv_resblock_chain_wgmma_bf16.argtypes = [p] * 4 + [i] * 9 + [p]
    lib.deepinv_resblock_chain_wgmma_bf16.restype = i
    lib.deepinv_conv_chain_wgmma_bf16.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.deepinv_conv_chain_wgmma_bf16.restype = i
    lib.deepinv_conv_chain_stash_bf16.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.deepinv_conv_chain_stash_bf16.restype = i
    lib.deepinv_conv_chain_stash_wgmma_bf16.argtypes = [p] * 4 + [i] * 9 + [p]
    lib.deepinv_conv_chain_stash_wgmma_bf16.restype = i
    lib.deepinv_chain_bwd_head_bf16.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.deepinv_chain_bwd_head_bf16.restype = i
    lib.deepinv_chain_bwd_dx_wgmma_bf16.argtypes = [p] * 5 + [i] * 10 + [p]
    lib.deepinv_chain_bwd_dx_wgmma_bf16.restype = i
    lib.deepinv_chain_bwd_fold_f32.argtypes = [p] * 2 + [i] * 2 + [p]
    lib.deepinv_chain_bwd_fold_f32.restype = i
    lib.deepinv_up_resblock_chain_bf16.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.deepinv_up_resblock_chain_bf16.restype = i
    lib.deepinv_up_sandwich_bf16.argtypes = [p] * 13 + [i] * 6 + [p]
    lib.deepinv_up_sandwich_bf16.restype = i
    plans = ctypes.POINTER(i)   # a launch plan (or several) as an int array
    lib.deepinv_up_resblock_chain_wgmma_bf16.argtypes = [p] * 6 + [i] * 5 + [plans, p]
    lib.deepinv_up_resblock_chain_wgmma_bf16.restype = i
    lib.deepinv_up_sandwich_wgmma_bf16.argtypes = [p] * 13 + [i] * 6 + [plans, p]
    lib.deepinv_up_sandwich_wgmma_bf16.restype = i
    lib.deepinv_resblock_chain_c128_wgmma_bf16.argtypes = [p] * 4 + [i] * 4 + [plans, p]
    lib.deepinv_resblock_chain_c128_wgmma_bf16.restype = i
    lib.deepinv_conv_c128_max_clusters.argtypes = []
    lib.deepinv_conv_c128_max_clusters.restype = i
    lib.deepinv_tv_prox_f32.argtypes = [p, p, i, p, p, i, i, i, i, p]
    lib.deepinv_tv_prox_f32.restype = i
    lib.deepinv_tv_prox_resident_f32.argtypes = [p, p, i, p] + [i] * 9 + [p]
    lib.deepinv_tv_prox_resident_f32.restype = i
    lib.deepinv_tv_resident_max_clusters.argtypes = [i, i, i, i]
    lib.deepinv_tv_resident_max_clusters.restype = i
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


def library_path() -> Path:
    """Where the library of this set of sources and flags is (or will be) built."""
    return BUILD_DIR / f"libdeepinv_kernels-{_digest()}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile the kernels if this set of sources has not been built yet,
    then load the library (once per process). Each ``.cu`` file is compiled
    by its own ``nvcc``, all started together, and the objects are linked
    into one library."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = []
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            cu = [s for s in _sources() if s.suffix == ".cu"]
            objs = [str(Path(tmpdir) / f"{s.stem}.o") for s in cu]
            compiles = [[cuda_tool("nvcc"), *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", o, str(s)]
                        for s, o in zip(cu, objs)]
            tmp = str(Path(tmpdir) / "lib.so")
            try:
                _run_all(compiles, log)
                _run_all([[cuda_tool("nvcc"), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]], log)
            finally:
                (BUILD_DIR / "build.log").write_text("\n".join(log))
            os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return _declare(ctypes.CDLL(str(so)))


def build_log() -> str:
    """The compiler's output from the last build in this checkout (register
    and shared-memory use per kernel, from ``-Xptxas -v``)."""
    log = BUILD_DIR / "build.log"
    return log.read_text() if log.exists() else ""

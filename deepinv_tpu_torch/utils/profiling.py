"""Profiling helpers (port of deepinv_tpu/utils/profiling.py).

- :func:`trace` is a ``torch.profiler`` session that writes a Chrome trace.
- :func:`timeit` is the median of synchronised calls: CUDA events where the
  result is on a CUDA device, the host clock otherwise.
- :func:`compiled_cost` counts the aten operations' flops of one call
  (``torch.utils.flop_counter``) and adds the kernel ops' analytic cost.

The kernel ops (DRUNet's chains K1, K2/K3 and K4) report their flops and
HBM bytes through :func:`record_pallas_cost`, with the JAX package's formulas
(deepinv_tpu/ops/pallas/resblock_chain.py:176-180, 219-221, 359-361, 564-575),
on the kernel and on the plain version alike: flop counters do not see into
a hand-written kernel, as XLA's cost analysis does not see into a Pallas call.
One difference: the JAX package records at trace time, so a ``lax.scan``
body counts once whatever its trip count, where the port runs eagerly and
counts every call. The two agree on one denoiser call.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["trace", "compiled_cost", "timeit", "record_pallas_cost"]

_record = []   # the open compiled_cost tallies, innermost last


def record_pallas_cost(flops: float, bytes_accessed: float) -> None:
    """Add a kernel op's analytic cost to the open :func:`compiled_cost`
    tally (profiling.py:29); nothing outside one."""
    if _record:
        _record[-1]["flops"] += float(flops)
        _record[-1]["bytes"] += float(bytes_accessed)


@contextlib.contextmanager
def trace(logdir: str = None):
    """A ``torch.profiler`` session over the block (CPU and, where there is
    one, CUDA activity) that writes ``logdir/trace.json``, a Chrome trace
    (profiling.py:38); ``logdir`` defaults to ``deepinv_torch_trace`` in the
    temporary directory::

        with trace("traces/hqs"):
            model(y, physics)
    """
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "deepinv_torch_trace")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_cost(fn, *args, **kwargs) -> dict:
    """The cost of one call ``fn(*args, **kwargs)`` (profiling.py:52):
    ``flops`` of the aten operations (``FlopCounterMode``, which counts
    matmuls and convolutions) plus the kernel ops' analytic flops, broken out
    as ``pallas_flops`` and ``pallas_bytes`` where any ran. The name is the
    JAX package's; nothing is compiled."""
    from torch.utils.flop_counter import FlopCounterMode

    _record.append({"flops": 0.0, "bytes": 0.0})
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            fn(*args, **kwargs)
    finally:
        rec = _record.pop()
    out = {"flops": float(counter.get_total_flops())}
    if rec["flops"] or rec["bytes"]:
        out["pallas_flops"] = rec["flops"]
        out["pallas_bytes"] = rec["bytes"]
        out["flops"] += rec["flops"]
        out["bytes accessed"] = rec["bytes"]
    return out


def _sync(out) -> bool:
    """Wait for ``out`` if it is (or holds) a CUDA tensor; whether it did."""
    leaves = out if isinstance(out, (tuple, list)) else [out]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()
        return True
    return False


def timeit(fn, *args, repeats: int = 5, **kwargs) -> float:
    """Median seconds of ``fn(*args, **kwargs)`` over ``repeats`` calls after
    one warm-up (profiling.py:94): CUDA events around each call where the
    result is on a CUDA device, the host clock otherwise."""
    import numpy as np

    cuda = _sync(fn(*args, **kwargs))
    ts = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))

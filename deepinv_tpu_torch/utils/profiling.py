"""Profiling helpers (port of deepinv_tpu/utils/profiling.py).

- :func:`span` marks one layer's work: the reconstruction, an iteration,
  the data fidelity, the prior, a kernel op. Spans are off unless a
  :func:`recording` block is open; inside one, a span is kept as a
  :class:`SpanRecord` and, while a ``torch.profiler`` runs, put on its
  timeline.
- :data:`counters` holds every integer count the library keeps about itself.
- :func:`trace` is a ``torch.profiler`` session, recording, that writes a
  Chrome trace with the spans on it.
- :func:`timeit` is the median of synchronised calls: CUDA events where the
  result is on a CUDA device, the host clock otherwise.
- :func:`compiled_cost` counts the aten operations' flops of one call
  (``torch.utils.flop_counter``) and adds the kernel ops' analytic cost.

The kernel ops (``ops/kernels/``) open their span through
:func:`kernel_span` with their analytic flops and HBM bytes, on the kernel
and on the plain version alike: flop counters do not see into a
hand-written kernel, as XLA's cost analysis does not see into a Pallas call.
DRUNet's chains K1, K2/K3 and K4 and DnCNN's K5 and K6 count with the JAX
package's formulas (deepinv_tpu/ops/pallas/resblock_chain.py:176-180,
219-221, 359-361, 564-575, conv_chain.py:299-301, 344-346). One difference:
the JAX package records at trace time, so a ``lax.scan`` body counts once
whatever its trip count, where the port runs eagerly and counts every call.
The two agree on one denoiser call.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "compiled_cost", "timeit", "record_pallas_cost", "span", "kernel_span",
           "traced", "recording", "SpanRecord", "Counters", "counters", "RECON", "ITERATION",
           "DATA_FIDELITY", "PRIOR", "KERNEL"]

# span names: the library's layers, outermost first
RECON = "dinv.recon"
ITERATION = "dinv.iteration"
DATA_FIDELITY = "dinv.data_fidelity"
PRIOR = "dinv.prior"
KERNEL = "dinv.kernel."   # + the op's name


class Counters(dict):
    """Every integer count the library keeps about itself, by name:
    ``kernel.<op>.launches`` (the calls of a kernel op that reached its CUDA
    kernel; the stash backward's kernel launches), ``loop.loops``,
    ``loop.host_reads`` and ``loop.bodies`` (:func:`~deepinv_tpu_torch.core.
    device_while`). A name never counted reads 0. The counts are always on,
    one dict increment each, made on the host when the work is issued: a
    replay of a captured CUDA graph increments none of them."""

    def __missing__(self, name):
        return 0

    def reset(self, *names):
        """Set ``names`` (every count if none is given) back to 0."""
        if not names:
            self.clear()
        for name in names:
            self.pop(name, None)

    def snapshot(self) -> dict:
        """The counts as a plain dict, a copy."""
        return dict(self)


counters = Counters()


class SpanRecord(NamedTuple):
    """One closed span: its name, the name of the span it opened in (None
    at the outermost), the reconstruction it belongs to (the number of the
    enclosing ``dinv.recon`` span, None outside one), its start and end on
    the host's monotonic clock (``time.perf_counter_ns``) and its
    attributes."""

    name: str
    parent: str | None
    recon: int | None
    start_ns: int
    end_ns: int
    attrs: dict


_sinks = []                       # the record lists of the open recording() blocks
_recon_ids = itertools.count(1)   # the reconstructions' numbers
_local = threading.local()        # .stack: this thread's open spans, innermost last


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    """An open span (made only inside :func:`recording`)."""

    __slots__ = ("name", "attrs", "parent", "recon", "start", "rf")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.name == RECON:
            self.recon = next(_recon_ids)
        else:
            self.recon = top.recon if top is not None else None
        stack.append(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        rec = SpanRecord(self.name, self.parent, self.recon, self.start, end, self.attrs)
        for sink in _sinks:
            sink.append(rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that marks one layer's work under ``name``.

    Outside :func:`recording` it costs a flag read and returns a shared
    no-op context, under a profiler too. Inside, it adds one
    :class:`SpanRecord`, whose parent is the span it opened in; a
    ``dinv.recon`` span starts a new reconstruction number, which every span
    inside it carries. While a ``torch.profiler`` runs it also opens
    ``torch.profiler.record_function(name)``, so the span sits on the
    profiler's timeline beside the device operations it launched."""
    if not _sinks:
        return _OFF
    return _Span(name, attrs)


def kernel_span(op: str, flops: float, nbytes: float):
    """The span ``dinv.kernel.<op>`` of one kernel-op call, carrying the
    op's analytic ``flops`` and HBM ``bytes``, which :func:`compiled_cost`
    adds up."""
    if not _sinks:
        return _OFF
    return _Span(KERNEL + op, {"flops": float(flops), "bytes": float(nbytes)})


def record_pallas_cost(flops: float, bytes_accessed: float) -> None:
    """Report the analytic cost of a kernel call site that has no span of
    its own (the JAX package's name, profiling.py:29): a kernel span of no
    duration, ``dinv.kernel.recorded``, which :func:`compiled_cost` adds
    up; nothing outside :func:`recording`."""
    with kernel_span("recorded", flops, bytes_accessed):
        pass


def traced(name: str, **attrs):
    """Decorate a function so that its outermost call opens ``span(name,
    **attrs)``: a call made inside an open span of the same name (a prox by
    inner gradient steps calling the gradient, a subclass calling its base)
    opens none."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _sinks:
                return fn(*args, **kwargs)
            stack = _stack()
            if stack and stack[-1].name == name:
                return fn(*args, **kwargs)
            with _Span(name, attrs):
                return fn(*args, **kwargs)

        inner.span_name = name
        return inner

    return wrap


@contextlib.contextmanager
def recording():
    """Keep the spans closed inside the block: yields the list the
    :class:`SpanRecord`\\ s are appended to as each span closes (so a span
    comes after the spans inside it). Blocks nest; each gets every span
    closed inside it."""
    records = []
    _sinks.append(records)
    try:
        yield records
    finally:
        # by identity: list.remove would take the first equal list
        del _sinks[next(i for i, s in enumerate(_sinks) if s is records)]


@contextlib.contextmanager
def trace(logdir: str = None):
    """A ``torch.profiler`` session over the block (CPU and, where there is
    one, CUDA activity) inside :func:`recording`, that writes
    ``logdir/trace.json``, a Chrome trace (profiling.py:38) with the
    library's spans on its timeline; ``logdir`` defaults to
    ``deepinv_torch_trace`` in the temporary directory::

        with trace("traces/hqs"):
            model(y, physics)
    """
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "deepinv_torch_trace")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    os.makedirs(logdir, exist_ok=True)
    with recording(), profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_cost(fn, *args, **kwargs) -> dict:
    """The cost of one call ``fn(*args, **kwargs)`` (profiling.py:52):
    ``flops`` of the aten operations (``FlopCounterMode``, which counts
    matmuls and convolutions) plus the analytic flops of the kernel ops'
    spans, broken out as ``pallas_flops`` and ``pallas_bytes`` where any
    ran. The name is the JAX package's; nothing is compiled."""
    from torch.utils.flop_counter import FlopCounterMode

    with recording() as records, FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args, **kwargs)
    kernels = [r.attrs for r in records if r.name.startswith(KERNEL)]
    out = {"flops": float(counter.get_total_flops())}
    if kernels:
        out["pallas_flops"] = sum(a["flops"] for a in kernels)
        out["pallas_bytes"] = sum(a["bytes"] for a in kernels)
        out["flops"] += out["pallas_flops"]
        out["bytes accessed"] = out["pallas_bytes"]
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

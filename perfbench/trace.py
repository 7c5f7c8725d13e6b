"""The traced run: a fixed number of calls under ``torch.profiler``, with
spans the benchmark opens itself (``pb.call`` around each call,
``pb.denoiser`` around each denoiser call), reduced to what the per-layer
metrics read.

A device operation belongs to a span when the host launched it inside the
span: the profiler gives each kernel the correlation id of its launch
(``cudaLaunchKernel`` or the CUDA driver's), whatever library made the call.
An operation whose launch the trace does not hold is an error. The device
is busy for the union of the operations' intervals: kernels launched with
programmatic dependent launch start while the one before runs
(``chip_smoke.py``'s ``device_profile``).

The profiler slows the host's issue of every call, so the wall time a call
takes at the cell's load is read from the same number of calls run
untraced in the same process, just before the traced ones.
"""

import bisect
import time
from collections import defaultdict
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile, record_function

CALL, DENOISER = "pb.call", "pb.denoiser"
SPIN = "spin_kernel"   # torch.cuda._sleep's kernel, which brackets the window


class Span(torch.nn.Module):
    """A denoiser called inside a span of the benchmark's own (traced runs
    only)."""

    def __init__(self, inner, name=DENOISER):
        super().__init__()
        self.inner, self.name = inner, name

    def forward(self, x, sigma=None, **kwargs):
        with record_function(self.name):
            return self.inner(x, sigma, **kwargs)


def traced_window(cell, calls, keep, device):
    """``calls`` calls untraced, then ``calls`` calls under the profiler,
    each synchronized as in the measured window."""
    cuda = torch.device(device).type == "cuda"

    def one(k):
        out = cell.call(k)
        if cuda:
            torch.cuda.synchronize()
        if out is not None:
            keep.offer(k, out)

    u0 = time.perf_counter()
    for k in range(calls):
        one(k)
    untraced_s = time.perf_counter() - u0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        # a short spin kernel first and last: the profiler drops one launch of
        # the window, and it should be one of these, which are left out
        if cuda:
            torch.cuda._sleep(1000)
        t0 = time.perf_counter()
        for k in range(calls, 2 * calls):
            with record_function(CALL):
                one(k)
        t1 = time.perf_counter()
        if cuda:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    return SimpleNamespace(calls=calls, window_s=t1 - t0, untraced_calls=calls,
                           untraced_s=untraced_s, attempted=2 * calls, latencies_ms=[],
                           trace=reduce(events(prof)))


def events(prof):
    """``[(name, on_device, activity, start_ns, end_ns, correlation)]`` of
    the profiler's raw events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        start = e.start_ns()
        out.append((e.name(), dev, act, start, start + e.duration_ns(), e.correlation_id()))
    return out


def union_s(intervals):
    """Seconds covered by ``[(start_ns, end_ns)]``."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def _is_kernel(name, act):
    if act:
        return act == "kernel"
    return not name.startswith(("Memcpy", "Memset"))


def reduce(evs):
    """Busy seconds, kernel counts, each span's device time, and the
    breakdown (the device operations that took most time, the longest idle
    gaps by what the host was doing)."""
    ops, launches, spans, host = [], {}, defaultdict(list), []
    for name, dev, act, a, b, corr in evs:
        if dev:
            if "annotation" not in act and not name.startswith("pb.") and SPIN not in name:
                ops.append((a, b, name, _is_kernel(name, act), corr))
        else:
            host.append((a, b, name))
            if name.startswith("pb."):
                spans[name].append((a, b))
            elif (act in ("cuda_runtime", "cuda_driver") if act
                  else name.startswith(("cuda", "cu"))):
                launches[corr] = a
    orphans = [op[2] for op in ops if op[4] not in launches]
    if orphans:
        raise RuntimeError(f"{len(orphans)} of {len(ops)} device operations have no launch "
                           f"in the trace, the first {orphans[0][:120]!r}")
    span_ops = {}
    for sname, ranges in spans.items():
        ranges = sorted(ranges)
        starts = [r[0] for r in ranges]
        members = [[] for _ in ranges]
        for op in ops:
            t = launches[op[4]]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                members[i].append(op)
        span_ops[sname] = members
    span_busy = {n: [union_s([(o[0], o[1]) for o in m]) for m in mem]
                 for n, mem in span_ops.items()}
    span_kernels = {n: [sum(o[3] for o in m) for m in mem] for n, mem in span_ops.items()}
    return SimpleNamespace(busy_s=union_s([(o[0], o[1]) for o in ops]),
                           kernels=sum(o[3] for o in ops), span_busy_s=span_busy,
                           span_kernels=span_kernels, breakdown=breakdown(ops, host, spans))


def breakdown(ops, host, spans, top=10):
    per = defaultdict(int)
    for a, b, name, _, _ in ops:
        per[name[:160]] += b - a
    device_ops = [[n, t / 1e9] for n, t in sorted(per.items(), key=lambda kv: -kv[1])[:top]]
    merged = []
    for a, b, *_ in sorted(ops):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        op = min(inside)[1] if inside else "no host op"
        span = min(((e - s, n) for n, rs in spans.items() for s, e in rs if s <= mid <= e),
                   default=(0, "outside the calls"))[1]
        idle.append([f"{span} > {op}"[:160], length / 1e9])
    return {"device_ops": device_ops, "idle_gaps": idle}

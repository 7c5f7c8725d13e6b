"""Everything a run does, for any cell: find the cell's files by the names
``BENCHMARK.json`` gives, set it up, drive the measured window, judge what
the window produced against the plain reference, and read the metrics.

A cell's traffic file names its kind (``kinds/<kind>.py``, the general
generator of that kind of traffic), its physics and solver; its
configuration file names the network's family. A metric ``m`` is read by
``metrics/<m>.py``, a cell's limits are ``limits/<cell>.json``.
"""

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the top-level names the run's process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "deepinv_tpu")


def load_json(path):
    return json.loads(Path(path).read_text())


def load_module(rel):
    """The module in ``perfbench/<rel>``: imported by its dotted name, or
    loaded by its path where the file's name holds ``.`` or ``-`` (a
    metric's name)."""
    parts = rel[:-len(".py")].split("/")
    if all(p.isidentifier() for p in parts):
        return importlib.import_module(".".join(["perfbench", *parts]))
    name = ".".join(["perfbench", *parts[:-1], parts[-1].replace(".", "_").replace("-", "_")])
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, HERE / rel)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name, bench=None):
    """``(workload entry, configuration, traffic, limits)`` of cell ``name``."""
    bench = bench if bench is not None else benchmark()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = load_json(ROOT / c["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return w, cfg, traffic, limits


def metrics_of(name, bench, traced):
    """The metrics a run of cell ``name`` reports: the end-to-end ones in a
    plain run, the per-layer ones in a traced run."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


def stamp(cell, label):
    """Print how far set-up has come (seconds since the process started)."""
    t = getattr(cell, "t_start", None)
    if t is not None:
        print(f"set-up: {label} at {time.perf_counter() - t:.2f} s", file=sys.stderr,
              flush=True)


def seed_int(seed):
    return int(seed) % 2 ** 63


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed_int(seed))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the seed
    as they come (Vitter's algorithm R), and the last answer."""

    def __init__(self, k, seed):
        self.k, self.rng, self.n = k, np.random.default_rng(seed_int(seed)), 0
        self.items, self.last = [], None

    def offer(self, index, item):
        if len(self.items) < self.k:
            self.items.append((index, item))
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = (index, item)
        self.n += 1
        self.last = (index, item)

    def sample(self):
        out = dict(self.items)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items())


def window(cell, seconds, keep, device):
    """Call the cell in a closed loop for ``seconds``: each call from its
    start to its synchronized result, timed on the device's own clock (CUDA
    events) where there is one. Returns the calls and their times."""
    cuda = torch.device(device).type == "cuda"
    lat = []
    if cuda:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    k, t0 = 0, time.perf_counter()
    while True:
        t_call = time.perf_counter()
        if cuda:
            ev[0].record()
        out = cell.call(k)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
            lat.append(ev[0].elapsed_time(ev[1]))
        t_end = time.perf_counter()
        if not cuda:
            lat.append((t_end - t_call) * 1e3)
        if out is not None:
            keep.offer(k, out)
        k += 1
        if t_end - t0 >= seconds:
            break
    return SimpleNamespace(calls=k, window_s=t_end - t0, attempted=k, latencies_ms=lat)


def percentile(vals, q):
    """The ``q`` quantile of ``vals``, linear between order statistics
    (``chip_smoke.py``'s ``percentile``)."""
    return float(np.percentile(np.asarray(vals, np.float64), q * 100))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(numbers, limits):
    """``(correct, checks)``: each number beside its limit, in the limits'
    order; a number missing or not finite fails."""
    checks, ok = {}, True
    for key, lim in limits["numbers"].items():
        v = numbers.get(key, float("nan"))
        checks[key] = {"value": v, "limit": lim["limit"]}
        ok = ok and math.isfinite(v) and v <= lim["limit"]
    return ok, checks


def run_cell(name, seed, seconds, traced, device, t_start, overrides=None):
    """One run of cell ``name``: the result line's dict, the numbers that
    decided ``correct`` last. ``overrides`` replace traffic entries (a CPU
    test's small sizes)."""
    bench = benchmark()
    w, cfg, traffic, limits = cell_files(name, bench)
    traffic = {**traffic, **(overrides or {})}
    kind = load_module(f"kinds/{traffic['kind']}.py")
    cell = kind.Cell(cfg, traffic, seed, device, traced)
    cell.t_start = t_start
    stamp(cell, "imports")
    cell.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    keep = Reservoir(traffic["check"], seed)
    if traced:
        from perfbench import trace

        stats = trace.traced_window(cell, traffic["trace_calls"], keep, device)
    else:
        stats = window(cell, seconds, keep, device)
    cuda = torch.device(device).type == "cuda"
    peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    numbers = cell.check(keep.sample())
    correct, checks = judge(numbers, limits)
    ctx = SimpleNamespace(kind=traffic["kind"], setup_s=setup_s, percentile=percentile,
                          **vars(stats), **cell.counts())
    metrics = {}
    for m in metrics_of(name, bench, traced):
        v = load_module(f"metrics/{m['name']}.py").read(ctx)
        if v is None and not traced:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": bool(correct), "attempted": stats.attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = stats.trace.busy_s
        dev["window_s"] = stats.window_s
        result["breakdown"] = stats.trace.breakdown
    result["checks"] = checks
    return result

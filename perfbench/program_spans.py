"""Read the program's own spans (``dinv.*``) in one cell, beside the
benchmark's, in one process: a reading outside the result line, until the
traced run reads them itself.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> [--rounds 3]

After the cell's set-up it runs ``rounds`` times ``trace_calls`` recons
untraced, then as many inside the program's ``recording()`` (no profiler),
then ``trace_calls`` recons inside ``recording()`` under ``torch.profiler``
with the benchmark's ``pb.call`` span around each, and prints one JSON line:

- ``wall_ms``: a recon's wall time, untraced and recorded (median, mean,
  quartiles), and ``recorded_over_untraced``, the recording's cost;
- ``host_issue_ms``: the median host duration of the recorded ``dinv.recon``
  spans, from the program's entry to its return, before the sync;
- ``data_fidelity_ms``: the device time (union of intervals) of what the
  ``dinv.data_fidelity`` spans launched, over profiled recons x iterations,
  beside ``data_step_ms`` (the accepted reading) of the same recons;
- ``kernel_roofline``: the least time of the convs the ``dinv.kernel.*``
  spans cover (K1's 4 ResBlocks for DRUNet, the hidden chain for DnCNN),
  counted from shapes, over the device time of what those spans launched;
- the launch calls' durations, and every idle gap's time by the innermost
  ``dinv.`` span at its middle.

The trace's reduction (``trace.reduce``) reads ``pb.`` spans only, and on a
profiler whose events carry no activity type it would take a ``dinv.``
span's device-side annotation for a device operation: the annotations are
left out, and the ``dinv.`` host spans renamed ``pb.dinv.*`` for it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def least_kernel_s(family, cfg, traffic, shape, peak):
    """The least time of the convs one kernel-op call covers: K1's 4
    bias-free ResBlocks (8 convs) at DRUNet's scale 0, or DnCNN's ``depth -
    2`` hidden convs with biases, at 64 channels; bf16 input, output and
    weights read or written once."""
    C, H, W = shape
    B = traffic["batch"]
    conv = 2 * H * W * 64 * 64 * 9
    wbytes = 9 * 64 * 64 * 2
    act = 2 * 2 * B * 64 * H * W
    if family == "drunet":
        flops, nbytes = B * 2 * cfg["nb"] * conv, act + 2 * cfg["nb"] * wbytes
    else:
        L = cfg["depth"] - 2
        flops, nbytes = B * L * conv, act + L * (wbytes + 64 * 4)
    return max(flops / peak["bf16_flops_per_s"], nbytes / peak["bytes_per_s"])


def split(raw):
    """``raw`` (``trace.events``) without the ``dinv.`` spans' device-side
    annotations, and the same with the ``dinv.`` host spans renamed
    ``pb.dinv.*``, which ``trace.reduce`` reads as spans."""
    evs = [e for e in raw if not (e[1] and e[0].startswith("dinv."))]
    return evs, [(("pb." + e[0]) if not e[1] and e[0].startswith("dinv.") else e[0], *e[1:])
                 for e in evs]


def read(name, seed, rounds, device, overrides=None):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from deepinv_tpu_torch.utils import profiling
    from perfbench import harness, trace

    _, cfg, traffic, _ = harness.cell_files(name)
    traffic = {**traffic, **(overrides or {})}
    kind = harness.load_module(f"kinds/{traffic['kind']}.py")
    cell = kind.Cell(cfg, traffic, seed, device, traced=True)
    cell.t_start = T0
    cell.setup()
    harness.sync(device)
    cuda = torch.device(device).type == "cuda"
    n, k = traffic["trace_calls"], [1]

    def one():
        t = time.perf_counter()
        cell.call(k[0])
        harness.sync(device)
        k[0] += 1
        return (time.perf_counter() - t) * 1e3

    walls, issue, spans = {"untraced": [], "recorded": []}, [], 0
    for _ in range(rounds):
        walls["untraced"] += [one() for _ in range(n)]
        with profiling.recording() as recs:
            walls["recorded"] += [one() for _ in range(n)]
        issue += [(r.end_ns - r.start_ns) / 1e6 for r in recs if r.name == profiling.RECON]
        spans += len(recs)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profiling.recording(), profile(activities=acts) as prof:
        if cuda:
            torch.cuda._sleep(1000)
        for _ in range(n):
            with record_function(trace.CALL):
                one()
        if cuda:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    evs, renamed = split(trace.events(prof))
    base, r = trace.reduce(evs), trace.reduce(renamed)
    counts = cell.counts()
    sb = r.span_busy_s
    calls, den = sb.get(trace.CALL, []), sb.get(trace.DENOISER, [])
    df = sb.get("pb.dinv.data_fidelity", [])
    kernel = "resblock_chain" if cfg["family"] == "drunet" else "conv_chain"
    ks = sb.get(f"pb.dinv.kernel.{kernel}", [])
    per_iter = len(calls) * counts["iterations_per_call"]
    launch = sorted((b - a) / 1e6 for nm, dev, _, a, b, _ in evs
                    if not dev and nm.startswith(("cudaLaunch", "cuLaunch")))
    merged = []
    for a, b in sorted((a, b) for nm, dev, act, a, b, _ in evs
                       if dev and "annotation" not in act and not nm.startswith("pb.")
                       and trace.SPIN not in nm):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    dspans = [(a, b, nm) for nm, dev, _, a, b, _ in evs if not dev and nm.startswith("dinv.")]
    idle = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        inner = min(((e - s, nm) for s, e, nm in dspans if s <= mid <= e),
                    default=(0, "outside dinv.recon"))[1]
        idle[inner] = idle.get(inner, 0.0) + (b - a) / 1e6 / n
    med = {g: statistics.median(v) for g, v in walls.items()}
    out = {"cell": name, "seed": seed,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "recons_per_group": n * rounds, "spans_per_recon": spans / (n * rounds),
           "wall_ms": {g: {"median": med[g], "mean": statistics.fmean(v),
                           "q": statistics.quantiles(v, n=4)} for g, v in walls.items()},
           "recorded_over_untraced": med["recorded"] / med["untraced"] - 1,
           "host_issue_ms": statistics.median(issue),
           "host_issue_q": statistics.quantiles(issue, n=4),
           "data_fidelity_ms": 1e3 * sum(df) / per_iter if df and cuda else None,
           "data_step_ms": 1e3 * (sum(calls) - sum(den)) / per_iter if cuda else None,
           "kernels_per_recon": base.kernels / n,
           "launch_calls": len(launch), "launch_ms_max": launch[-1] if launch else None,
           "launch_over_0.1ms": sum(x > 0.1 for x in launch),
           "idle_ms_a_recon_by_program_span": idle,
           "idle_gaps": r.breakdown["idle_gaps"]}
    if cuda and sum(ks) > 0:
        least = least_kernel_s(cfg["family"], cfg, traffic, cell.shape, counts["peak"])
        out["kernel_roofline"] = 100 * least * len(ks) / sum(ks)
        out["kernel_ms_a_call"] = 1e3 * sum(ks) / len(ks)
    if cuda:
        out["device_idle_recon"] = 100 * (1 - base.busy_s / n / (med["untraced"] / 1e3))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("program_spans: no CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(read(a.workload, a.seed, a.rounds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

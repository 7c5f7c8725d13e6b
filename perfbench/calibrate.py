"""The readings the limits of ``correct`` are set from, at a cell's own
size, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2 [--out FILE]

For each of ``--seeds``: the cell's set-up and a short window of the timed
path, then the numbers ``correct`` compares (the lower reading is their
largest). For each of ``--control-seeds`` the same set-up and window, then
the numbers with the program's answers replaced by the control, the plain
reference computed one precision lower (float8 for the bfloat16
configurations; the upper reading is the least of these). The benchmark's
own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell_name, seed, seconds, device, mode, overrides=None):
    """The numbers of one seed: ``mode`` is ``program`` or ``control``."""
    from perfbench import harness

    _, cfg, traffic, _ = harness.cell_files(cell_name)
    traffic = {**traffic, **(overrides or {})}
    cell = harness.load_module(f"kinds/{traffic['kind']}.py").Cell(cfg, traffic, seed, device)
    cell.setup()
    keep = harness.Reservoir(traffic["check"], seed)
    harness.window(cell, seconds, keep, device)
    if mode == "program":
        return cell.check(keep.sample())
    return cell.check(keep.sample(), against=lambda i: cell.reference(i, "fp8"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    out = {"workload": a.workload, "program": {}, "control": {}}
    runs = [("program", int(s)) for s in a.seeds.split(",")]
    runs += [("control", int(s)) for s in a.control_seeds.split(",") if s]
    for mode, seed in runs:
        t0 = time.perf_counter()
        out[mode][seed] = readings(a.workload, seed, a.seconds, "cuda", mode)
        print(f"{mode} seed {seed}: {out[mode][seed]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for mode in ("program", "control"):
        for key in next(iter(out[mode].values()), {}):
            vals = [r[key] for r in out[mode].values()]
            print(f"{mode} {key}: max {max(vals)!r} min {min(vals)!r}", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

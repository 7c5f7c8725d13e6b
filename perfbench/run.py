"""Run one cell of ``BENCHMARK.json`` once, on the card this process finds.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, one JSON object; the numbers
that decided ``correct``, each beside its limit, are the last lines of
standard error. Exits with 2, and prints no result, where there is no CUDA
card or fewer than the cell asks for, and with 3 where the process holds
JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout, so that
# only a cell's first run in a checkout builds (the port's own kernels build
# into deepinv_tpu_torch/_build/)
CACHE = ROOT / ".perfbench_cache"
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels", "CUDA_CACHE_PATH": "cuda"}


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().replace("\n", "; ")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host issues the card's work, and
    # idle intra-op threads would only contend for its cores
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)

    from perfbench import harness

    w = harness.cell_files(a.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"perfbench: {w['name']} needs {w['chips']} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found} after the window", file=sys.stderr)
        return 3
    print(f"perfbench: {w['name']} seed {a.seed}; card: {card_line()}", flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

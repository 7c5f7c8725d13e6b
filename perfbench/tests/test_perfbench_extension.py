"""A later change adds a configuration, a traffic mix, a physics (its plain
reference and the program's side), a limit and a metric as files and
entries only: a copy of the benchmark with a cell of this test's own runs
through the harness unchanged."""

import json
import shutil
import subprocess
import sys

from perfbench import harness

CONFIG = {"family": "dncnn", "depth": 5, "nf": 16, "bias": True, "act_mode": "R",
          "dtype": "bfloat16", "program": {"wrapper": "autocast"}, "reduced": [],
          "weights": {"init": "he_normal", "bias_std": 0.01, "out_gain": 0.1}}
TRAFFIC = {"kind": "recon", "solver": "PGD", "params_algo": {"stepsize": 1.0, "g_param": 0.05},
           "max_iter": 3, "physics": "denoising", "physics_args": {}, "noise_sigma": 0.05,
           "image": {"channels": 1, "height": 24, "width": 24, "f0": 0.05}, "batch": 2,
           "pool": 2, "check": 2, "trace_calls": 2}
REF_PHYSICS = '''"""Plain denoising: A is the identity, y = x + noise."""


def make(spec, shape, generator, device):
    return {}


class Op:
    def __init__(self, tensors, shape):
        pass

    def A_adjoint(self, y):
        return y

    def grad(self, x, y):
        return x - y

    def measure(self, x, noise):
        return x + noise
'''
PROGRAM_PHYSICS = '''def build(tensors, traffic, shape, device):
    from deepinv_tpu_torch.physics import Denoising, GaussianNoise

    return Denoising(GaussianNoise(sigma=traffic["noise_sigma"], device=device))
'''
METRIC = '''def read(ctx):
    return ctx.percentile(ctx.latencies_ms, 0.5) if ctx.kind == "recon" else None
'''
DRIVE = '''import json, sys, time
sys.path.insert(0, ".")
sys.path.append(sys.argv[1])
from perfbench import harness
res = harness.run_cell("tiny.pgd-denoise-24", 7, 0.3, False, "cpu", time.perf_counter())
print(json.dumps(res))
'''


def test_a_cell_added_by_files_and_entries(tmp_path):
    bench = harness.benchmark()
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    (pb / "configs/tiny.json").write_text(json.dumps(CONFIG))
    (pb / "traffic/pgd-denoise-24.json").write_text(json.dumps(TRAFFIC))
    (pb / "limits/tiny.pgd-denoise-24.json").write_text(
        json.dumps({"numbers": {"xhat_rel_l2": {"limit": 0.05}}}))
    (pb / "metrics/recon_ms_p50.py").write_text(METRIC)
    (pb / "reference/phys_denoising.py").write_text(REF_PHYSICS)
    (pb / "program/phys_denoising.py").write_text(PROGRAM_PHYSICS)
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/1608.03981",
                             "file": "perfbench/configs/tiny.json", "reduced": [],
                             "why": "a test's own"})
    bench["workloads"].append({"name": "tiny.pgd-denoise-24", "config": "tiny",
                               "traffic": "pgd-denoise-24", "chips": 1, "why": "a test's own"})
    bench["end_to_end"].append({"name": "recon_ms_p50", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "device_trace",
                                "workloads": ["tiny.pgd-denoise-24"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("recon_images_per_s", "recon_ms_p95"):
            m["workloads"].append("tiny.pgd-denoise-24")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in harness.HERE.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    r = subprocess.run([sys.executable, "-c", DRIVE, str(harness.ROOT)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["metrics"]) == {"recon_images_per_s", "recon_ms_p95", "recon_ms_p50",
                                   "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())

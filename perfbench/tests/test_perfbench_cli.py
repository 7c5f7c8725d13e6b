"""``run.py`` from its command line, on a host without a card."""

import shutil
import subprocess
import sys

from perfbench import harness

ARGS = ["--workload", "drunet.hqs-deblur-256-b16", "--seed", "3000000001", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    r = _run(harness.ROOT)
    assert r.returncode == 2
    assert "{" not in r.stdout and "CUDA card" in r.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and "{" not in r.stdout

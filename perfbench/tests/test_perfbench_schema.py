"""``BENCHMARK.json`` against the rules the benchmark keeps, and every file a
cell needs."""

import json
import re

import pytest

from perfbench import harness

B = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in B["end_to_end"]}
CELLS = [w["name"] for w in B["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(json.dumps(B).encode()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(B["paths"]) <= 16 and 1 <= len(B["command"]) <= 32
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in B["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word.split("/")
    files = [w for w in B["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in B["paths"]) for f in files)


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = B["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert 24 * 14 * (s + 60) + 2 * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    groups = (B["configs"], B["workloads"], B["end_to_end"], B["per_layer"])
    for g in groups:
        names = [e["name"] for e in g]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
    for c in B["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_sizes_of_groups():
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(B["workloads"]) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16 and 1 <= len(B["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in B["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in B["per_layer"])


def test_moves_and_workloads_of_metrics():
    for m in B["end_to_end"] + B["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in B["per_layer"]:
        assert m["moves"] in E2E
        for cell in (m["workloads"] if "workloads" in m else CELLS):
            assert _reports(E2E[m["moves"]], cell), (m["name"], cell)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    assert layers <= {"Reconstructor", "Iterator and physics", "Prior / denoiser", "Device"}


def test_every_config_is_used_and_its_file_agrees():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert len(set(files)) == len(files)
    for c in B["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_exists(cell):
    w, cfg, traffic, limits = harness.cell_files(cell)
    here = harness.HERE
    need = [f"kinds/{traffic['kind']}.py", f"reference/net_{cfg['family']}.py",
            f"program/net_{cfg['family']}.py", f"counts/net_{cfg['family']}.py",
            f"reference/phys_{traffic['physics']}.py", f"program/phys_{traffic['physics']}.py"]
    if "solver" in traffic:
        need.append(f"reference/solver_{traffic['solver'].lower()}.py")
    need += [f"metrics/{m['name']}.py" for m in B["end_to_end"] + B["per_layer"]
             if _reports(m, cell)]
    for rel in need:
        assert (here / rel).is_file(), rel
    for key, lim in limits["numbers"].items():
        assert 0 < lim["limit"] and key

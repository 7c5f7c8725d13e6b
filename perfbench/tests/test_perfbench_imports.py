"""What the benchmark's modules import, by the whole top-level name of each
module (``deepinv_tpu_torch`` begins with ``deepinv_tpu``)."""

import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "deepinv_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def top_names(path):
    """The top-level names a file imports; a relative import reads as the
    benchmark's own package."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("perfbench" if node.level else node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(HERE)) for p in FILES])
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_torch_numpy_and_itself_only(path):
    allowed = {"torch", "numpy", "perfbench"} | set(sys.stdlib_module_names)
    assert top_names(path) <= allowed
    assert "deepinv_tpu_torch" not in top_names(path)


def test_the_scan_sees_a_relative_import_and_a_whole_name(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("from . import x\nimport deepinv_tpu_torch.models\nfrom jax import numpy\n")
    assert top_names(f) == {"perfbench", "deepinv_tpu_torch", "jax"}
    assert top_names(f) & FORBIDDEN == {"jax"}

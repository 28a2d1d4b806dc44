"""Nothing in ``nsdp_bench`` imports JAX, flax or the JAX package, by the
top-level module name compared whole (``nsdp_tpu_torch`` begins with
``nsdp_tpu`` and is allowed); the reference imports nothing of the
program."""

import ast
from pathlib import Path

from nsdp_bench.tests.tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "nsdp_tpu"}


def imported(path: Path):
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported(path) & FORBIDDEN, path


def test_the_comparison_is_by_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import nsdp_tpu_torch.serving\nfrom nsdp_tpu_torch import graphs\n")
    assert imported(probe) == {"nsdp_tpu_torch"} and not imported(probe) & FORBIDDEN
    probe.write_text("import nsdp_tpu.serving\n")
    assert imported(probe) & FORBIDDEN == {"nsdp_tpu"}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "nsdp_tpu_torch" not in imported(path), path
    for name in ("counts.py", "weights.py", "traffic/generate.py"):
        assert "nsdp_tpu_torch" not in imported(BENCH / name), name

"""Nothing the benchmark runs loads JAX or the JAX package; the check
compares top-level names whole (``vlsat_tpu_torch`` begins with
``vlsat_tpu``), and the reference imports neither of those nor the
program."""

import ast
import sys

from benchmark.harness import core


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vlsat_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert "vlsat_tpu" not in core.forbidden_modules()
    assert "jax" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vlsat_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    found = core.forbidden_modules()
    assert "vlsat_tpu" in found and "jax" in found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_torch_and_numpy_only():
    for path in sorted((core.BENCH / "reference").glob("*.py")):
        assert set(_imports(path)) <= {"__future__", "math", "typing", "numpy", "torch"}, path


def test_nothing_in_the_benchmark_imports_jax():
    for path in sorted(core.BENCH.rglob("*.py")):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "vlsat_tpu"}, path

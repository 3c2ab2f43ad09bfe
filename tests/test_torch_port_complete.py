"""The port is complete against the JAX package, read from the sources with
``ast`` (neither package is imported).

(a) Every module of ``vlsat_tpu/``, and every JAX-era script in ``tools/``
    and at the root, has a twin in ``vlsat_tpu_torch/`` (the same relative
    path, ``tools/X.py`` as ``vlsat_tpu_torch/tools/X.py``, or a row of
    ``RENAMED``) or a row of ``EXCLUDED``.
(b) Every public name that such a module defines at top level, and every
    name that a JAX ``__init__.py`` re-exports, is defined or imported at top
    level of the twin, unless ``EXCLUDED_NAMES`` gives the reason.

A script is of the JAX era when it imports nothing of ``vlsat_tpu_torch``;
the scripts the port added (``chip_smoke.py``, ``tools/torch_*.py``,
``tools/flax_ckpt_to_torch.py``) import it.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = "vlsat_tpu", "vlsat_tpu_torch"

# JAX-era files whose twin has another name
RENAMED = {
    "bench.py": "vlsat_tpu_torch/tools/bench.py",
    "tools/xplane_summary.py": "vlsat_tpu_torch/tools/trace_summary.py",
}

# JAX-era files with no twin, by design
EXCLUDED = {
    "vlsat_tpu/interop/torch_oracle.py":
        "the reference's layer code in torch: the port's tests import it as an oracle",
    "vlsat_tpu/ops/pallas/__init__.py":
        "the Pallas kernels became vlsat_tpu_torch/csrc/ and vlsat_tpu_torch/ops/kernels/",
    "vlsat_tpu/ops/pallas/pointnet_kernel.py":
        "became vlsat_tpu_torch/csrc/pointnet.cu and ops/kernels/pointnet_kernel.py",
    "vlsat_tpu/ops/pallas/segment_max.py":
        "became vlsat_tpu_torch/csrc/segment_max.cu and ops/kernels/segment_max.py",
    "tools/bench_nn_edge_modes.py":
        "the port computes the three nn_edge modes with one formulation "
        "(vlsat_tpu_torch/models/registry.py): there is nothing to compare",
    "tools/bench_torch_baseline.py":
        "torch already; the port's bench reads its bench_baseline.json as bench.py does",
    "__graft_entry__.py": "the JAX era's entry point for a smoke run: chip_smoke.py takes its role",
}

# public names of twinned JAX modules that the twin lacks, by design
EXCLUDED_NAMES = {
    ("vlsat_tpu/parallel/mesh.py", "make_mesh"):
        "returns a JAX Mesh: parallel.init_data_parallel and its World take its role",
    ("vlsat_tpu/parallel/__init__.py", "make_mesh"): "re-exports the above",
    ("vlsat_tpu/clipsem/text_tables.py", "HFCLIPTextEncoder"):
        "waits for transformers and the CLIP ViT-B/32 weights, which are not in the "
        "repository; the port's tools raise clipsem.HF_MISSING",
    ("vlsat_tpu/clipsem/__init__.py", "HFCLIPTextEncoder"): "re-exports the above",
    ("vlsat_tpu/utils/profiling.py", "annotate"):
        "utils.profiling.span takes its place: a named range in the profiler's trace "
        "that also records a span",
}


def parse(rel: str) -> ast.Module:
    return ast.parse((REPO / rel).read_text(), filename=rel)


def top_level(tree: ast.Module):
    """Statements at module level, inside top-level if / try / with blocks
    too, not inside functions or classes."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody"):
                todo.extend(getattr(node, field, []))
            for handler in getattr(node, "handlers", []):
                todo.extend(handler.body)


def defined(tree: ast.Module) -> set:
    out = set()
    for node in top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return out


def imported(tree: ast.Module, prefix: str = "") -> set:
    """Names bound by top-level imports (from modules under ``prefix``)."""
    out = set()
    for node in top_level(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(prefix):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import) and not prefix:
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def imports_port(rel: str) -> bool:
    for node in ast.walk(parse(rel)):
        mods = ([node.module or ""] if isinstance(node, ast.ImportFrom) else
                [a.name for a in node.names] if isinstance(node, ast.Import) else [])
        if any(m == PORT or m.startswith(PORT + ".") for m in mods):
            return True
    return False


def jax_files() -> list:
    """Every module of vlsat_tpu/ and every JAX-era script, repo-relative."""
    mods = [p.relative_to(REPO).as_posix() for p in sorted((REPO / JAX).rglob("*.py"))]
    scripts = [p.relative_to(REPO).as_posix()
               for p in sorted((REPO / "tools").glob("*.py")) + sorted(REPO.glob("*.py"))]
    return mods + [s for s in scripts if not imports_port(s)]


def twin(rel: str) -> str:
    if rel in RENAMED:
        return RENAMED[rel]
    if rel.startswith(JAX + "/"):
        return PORT + rel[len(JAX):]
    return f"{PORT}/{rel}"


def public_names(rel: str) -> set:
    tree = parse(rel)
    names = {n for n in defined(tree) if not n.startswith("_")}
    if rel.endswith("__init__.py"):
        names |= imported(tree, prefix=JAX)
    return names


def group_of(rel: str) -> str:
    """The part of the JAX tree a file is in: a subpackage of vlsat_tpu/,
    its top-level modules, tools/ or the root's scripts."""
    parts = rel.split("/")
    if parts[0] == JAX:
        return parts[1] if len(parts) > 2 else JAX
    return "tools" if parts[0] == "tools" else "root"


JAX_FILES = jax_files()
TWINNED = [f for f in JAX_FILES if f not in EXCLUDED]
GROUPS = sorted({group_of(f) for f in TWINNED})  # the cases of (b)


def test_the_jax_tree_is_found():
    assert {"vlsat_tpu/scene.py", "vlsat_tpu/models/mmgnet.py", "tools/link_validate.py",
            "tools/serve.py", "bench.py", "__graft_entry__.py"} <= set(JAX_FILES)
    assert not {"chip_smoke.py", "tools/torch_mma_probe.py",
                "tools/flax_ckpt_to_torch.py"} & set(JAX_FILES)


def test_every_jax_module_has_a_twin_or_a_reason():
    missing = [f for f in TWINNED if not (REPO / twin(f)).is_file()]
    assert not missing, f"no twin in {PORT}/ and no row in EXCLUDED: {missing}"


def test_exclusion_rows_are_current():
    """Each row names a JAX-era file that exists and has no twin, or a name
    that the JAX module exports and its twin lacks: a row that no longer
    applies is removed."""
    for f in EXCLUDED:
        assert f in JAX_FILES and not (REPO / twin(f)).exists(), f
    for (f, name) in EXCLUDED_NAMES:
        assert f in TWINNED and name in public_names(f), (f, name)
        tree = parse(twin(f))
        assert name not in defined(tree) | imported(tree), (f, name)
    for f, t in RENAMED.items():
        assert f in JAX_FILES and (REPO / t).is_file() and not (REPO / f"{PORT}/{f}").exists()


@pytest.mark.parametrize("group", GROUPS)
def test_twins_define_the_public_names(group):
    lacking = {}
    for f in (f for f in TWINNED if group_of(f) == group):
        tree = parse(twin(f))
        have = defined(tree) | imported(tree)
        miss = sorted(n for n in public_names(f) - have if (f, n) not in EXCLUDED_NAMES)
        if miss:
            lacking[f"{f} -> {twin(f)}"] = miss
    assert not lacking, f"public names without a twin: {lacking}"

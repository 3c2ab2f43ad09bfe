"""The port's offline pipeline (``python -m vlsat_tpu_torch.tools.run_full_pipeline``)
against the JAX package's ``tools/run_full_pipeline.py``, on the CPU.

One 4-scan root laid out as the path contract asks: scans under
``<root>/data/3RScan/`` with RGB frames (``sequence/frames.json`` and PNG
files), ``--multi-view-root <root>``, so the eval stage reads the features
that the project stage wrote.  Both tools run ``project,text,eval`` on the
same experiment JSON (the flagship ``Mmgnet`` at narrow MODEL widths) in
their own copy of the root.  The two packages draw their first weights
differently, so the port's runner starts from the JAX runner's initial
state (``interop.from_flax``), as in tests/test_torch_port_runner.py.

Gates: projected ``.npy`` features, quality logs and text tables bit-equal;
validation metrics exactly equal on the bit-exact f32 wire; the port's
``train`` stage alone for one step (its parity is
tests/test_torch_port_runner.py's); ``zero_shot_analysis`` prints equal lines
in both packages.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.mini_data import make_mini_dataset
from tests.test_torch_port_packed import assert_same_metrics
from vlsat_tpu.train.runner import Runner as JaxRunner
from vlsat_tpu_torch.interop.from_flax import train_state_from_flax
from vlsat_tpu_torch.tools import run_full_pipeline as port_tool
from vlsat_tpu_torch.tools.zero_shot_analysis import main as port_zero_shot
from vlsat_tpu_torch.train.runner import Runner

REPO = Path(__file__).resolve().parents[1]
W, H, FRAMES = 96, 72, 3
NARROW = {"N_LAYERS": 1, "DIM_ATTEN": 64, "NUM_HEADS": 2}


def jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_frames(scan_dir: Path, rng) -> None:
    """A few cameras around the scan looking at its centre, and PNG frames."""
    seq = scan_dir / "sequence"
    seq.mkdir()
    intr = [[60.0, 0, W / 2, 0], [0, 60.0, H / 2, 0], [0, 0, 1, 0]]
    frames = []
    for f, a in enumerate(np.linspace(0, 2 * np.pi, FRAMES, endpoint=False)):
        eye = np.array([9 * np.cos(a), 9 * np.sin(a), 1.0])
        z = -eye / np.linalg.norm(eye)
        x = np.cross(z, [0, 0, 1.0])
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[:3, 3] = eye
        name = f"frame-{f:06d}.color.png"
        Image.fromarray(rng.randint(0, 255, (H, W, 3), dtype=np.uint8)).save(seq / name)
        frames.append({"color": name, "extrinsic": np.linalg.inv(c2w).tolist()})
    (seq / "frames.json").write_text(json.dumps(
        {"frames": frames, "intrinsic": intr, "width": W, "height": H}))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(base, config): the 3DSSG root and ``base/<pkg>/data/3RScan`` per
    package, each a copy of one set of scans with frames."""
    base = tmp_path_factory.mktemp("pipeline")
    root, scans = make_mini_dataset(base, num_scans=4)
    rng = np.random.RandomState(0)
    for scan in sorted(Path(scans).iterdir()):
        write_frames(scan, rng)
    for pkg in ("jax", "port"):
        shutil.copytree(scans, base / pkg / "data" / "3RScan")
    cfg = base / "cfg.json"
    cfg.write_text(json.dumps({"MODEL": NARROW, "Batch_Size": 2, "MAX_EPOCHES": 1,
                               "VALID_INTERVAL": 1, "dataset": {"num_points": 16}}))
    return base, root, str(cfg)


def argv(base: Path, root: str, cfg: str, pkg: str, stages: str) -> list:
    return ["--root", root, "--scans-root", str(base / pkg / "data" / "3RScan"),
            "--multi-view-root", str(base / pkg), "--out", str(base / pkg / "out"),
            "--config", cfg, "--encoder", "hash", "--stages", stages]


@pytest.fixture(scope="module")
def runs(roots):
    """Both tools' ``project,text,eval`` runs: the JAX tool in this process
    (its text stage is a subprocess), then the port's from JAX's state."""
    base, root, cfg = roots
    mp = pytest.MonkeyPatch()
    seen = {}
    validation = JaxRunner.validation

    def jax_validation(self, *a, **k):
        seen["state"] = jax.tree_util.tree_map(np.asarray, (
            self.state.params, self.state.batch_stats, self.state.opt_state))
        seen["jax"] = validation(self, *a, **k)
        return seen["jax"]

    def bridged(self):
        params, stats, opt = seen["state"]
        return train_state_from_flax(params, stats, opt, 0, model=self.model,
                                     optimizer=self.optimizer)

    try:
        mp.setenv("VLSAT_WIRE_DTYPE", "float32")
        mp.setattr(JaxRunner, "validation", jax_validation)
        mp.setattr(sys, "argv", ["run_full_pipeline.py",
                                 *argv(base, root, cfg, "jax", "project,text,eval")])
        jax_tool("run_full_pipeline").main()
        mp.setattr(Runner, "_fresh_state", bridged)
        port = port_tool.main([*argv(base, root, cfg, "port", "project,text,eval"),
                               "--device", "cpu"])
    finally:
        mp.undo()
    return base, root, cfg, seen["jax"], port


def test_pipeline_features_and_tables_equal_jax(runs):
    base, _, _, _, port = runs
    assert port["project"] == 8  # 4 scans in each of the two splits
    want = sorted((base / "jax" / "data" / "3RScan").rglob("multi_view/*"))
    got = sorted((base / "port" / "data" / "3RScan").rglob("multi_view/*"))
    assert [p.relative_to(base / "port") for p in got] == \
        [p.relative_to(base / "jax") for p in want]
    assert sum(p.suffix == ".npy" for p in want) == 16
    for g, w in zip(got, want):
        assert g.read_bytes() == w.read_bytes(), g.name
    for name in ("obj_text_table.npy", "rel_text_table.npy", "triplet_text_cache.npz"):
        assert (base / "port" / "out" / "clip_assets" / name).read_bytes() == \
            (base / "jax" / "out" / "clip_assets" / name).read_bytes(), name


def test_pipeline_eval_metrics_equal_jax(runs):
    """The eval stage read the projected features (the dataset raises on a
    missing file) and its metrics equal JAX's."""
    base, _, _, want, port = runs
    assert_same_metrics(port["eval"], want, "eval stage")
    assert "obj_acc_2d_1" in want
    res = base / "port" / "out" / "results" / "Mmgnet" / "default"
    assert (res / "result.txt").exists() and (res / "rel_scores_list.npy").exists()


def test_zero_shot_analysis_prints_equal_lines(runs, monkeypatch):
    base, root, _, _, _ = runs
    res = str(base / "port" / "out" / "results" / "Mmgnet" / "default")
    out = {}
    for pkg in ("jax", "port"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if pkg == "jax":
                monkeypatch.setattr(sys, "argv", ["t", "--results", res, "--root", root])
                jax_tool("zero_shot_analysis").main()
            else:
                port_zero_shot(["--results", res, "--root", root])
        out[pkg] = buf.getvalue()
    assert out["port"] == out["jax"] and out["jax"].count("\n") >= 4


def test_pipeline_train_stage_and_refusals(runs):
    """The train stage alone (one step: 4 scans at B=4), its checkpoint
    and closing validation; ``--encoder hf`` and a missing card refused."""
    base, root, cfg, _, _ = runs
    Path(cfg).write_text(json.dumps({**json.loads(Path(cfg).read_text()), "Batch_Size": 4}))
    res = port_tool.main([*argv(base, root, cfg, "port", "train"), "--device", "cpu"])
    assert "mean_recall_50" in res["train"]
    ckpts = base / "port" / "out" / "Mmgnet" / "default" / "checkpoints"
    assert any(ckpts.iterdir())
    with open(base / "port" / "out" / "Mmgnet" / "default" / "epoch_stats.jsonl") as f:
        assert json.loads(f.readline())["step"] == 1
    for stages in ("project", "text"):
        with pytest.raises(NotImplementedError, match="CLIP ViT-B/32"):
            port_tool.main([*argv(base, root, cfg, "port", stages)[:-4], "--stages", stages,
                            "--encoder", "hf", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_tool.main(argv(base, root, cfg, "port", "project"))


def test_project_stage_on_decoded_arrays_without_decoders(runs):
    """With PIL, imageio, jax, flax, optax and vlsat_tpu blocked, every
    offline module imports, and the project stage's body run on decoded
    frames (``stage_project(args, read=...)``) writes the features that the
    file route wrote; ``uv_to_color`` takes a decoded texture array."""
    import os
    import subprocess

    base, root, cfg, _, _ = runs
    scans = base / "arrays" / "data" / "3RScan"
    shutil.copytree(base / "scans", scans)
    for png in scans.rglob("*.png"):
        np.save(str(png) + ".npy", np.asarray(Image.open(png)))
        png.unlink()
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "vlsat_tpu", "PIL", "imageio"):
    sys.modules[name] = None
import importlib
import numpy as np
for name in ("preprocess.depth", "preprocess.transform", "preprocess.gen_data",
             "projection.multiview", "data.obj", "clipsem.adapter_train",
             "tools.build_multiview_features", "tools.align_scans", "tools.zero_shot_analysis",
             "tools.build_text_tables", "tools.run_full_pipeline"):
    importlib.import_module("vlsat_tpu_torch." + name)
from vlsat_tpu_torch.data.obj import uv_to_color
from vlsat_tpu_torch.tools import run_full_pipeline as p
tex = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
assert uv_to_color(np.array([[0.0, 1.0], [1.0, 0.0]]), tex).tolist() == [[0, 1, 2], [20, 21, 22]]
args = p.parse_args({argv(base, root, cfg, "arrays", "project")!r} + ["--device", "cpu"])
assert p.stage_project(args, read=lambda path: np.load(path + ".npy")) == 8
try:
    p.read_frame("x.png")
except ImportError:
    print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])))
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
    want = sorted((base / "port" / "data" / "3RScan").rglob("multi_view/*"))
    got = sorted(scans.rglob("multi_view/*"))
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert g.name == w.name and g.read_bytes() == w.read_bytes(), g

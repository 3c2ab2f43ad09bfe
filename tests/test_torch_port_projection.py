"""The port's multi-view projection front-end against the JAX package's, on
the CPU: ``project_points`` (a shared and a per-frame intrinsic, with and
without ``require_positive_depth``), the three view tiers of
``select_view_crops``, ``MultiViewFeatureExtractor.process_scene``'s saved
features and quality log, and ``tools/build_multiview_features.py``'s output.

Both packages get the same seeded numpy inputs.  Gates: pixel coordinates
at the parity gate of tests/test_parity_torch.py (fp32, rtol 1e-3, atol
1e-4); visibility, crops, tiers, saved ``.npy`` files, logs and listings
exactly equal.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsat_tpu import projection as JP
from vlsat_tpu_torch import projection as PP
from vlsat_tpu_torch.tools.run_full_pipeline import hash_image_encoder

RTOL, ATOL = 1e-3, 1e-4
REPO = Path(__file__).resolve().parents[1]
W, H, F = 160, 120, 4


def cameras(n: int = F, shift: int = 1) -> np.ndarray:
    """world -> camera extrinsics: cameras on a line looking down +z, the
    last ``shift`` of them moved far off so that they see nothing."""
    ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ext[:, 0, 3] = np.linspace(-0.3, 0.3, n)
    ext[n - shift:, 0, 3] = 50.0
    return ext


def intrinsics(per_frame: bool) -> np.ndarray:
    k = np.asarray([[80.0, 0, W / 2, 0], [0, 80.0, H / 2, 0], [0, 0, 1, 0]], np.float32)
    if not per_frame:
        return k
    ks = np.tile(k, (F, 1, 1))
    ks[:, 0, 0] += np.arange(F) * 7.0
    return ks


def points(seed: int, n: int = 60) -> np.ndarray:
    rng = np.random.RandomState(seed)
    p = (rng.rand(n, 3) - 0.5) * [1.6, 1.2, 0.5] + [0, 0, 2.0]
    p[:5, 2] = -2.0  # behind every camera
    return p.astype(np.float32)


def both_projections(pts, ext, k, positive: bool):
    jp, jv = JP.project_points(jnp.asarray(pts), jnp.asarray(ext), jnp.asarray(k), W, H,
                               require_positive_depth=positive)
    pp, pv = PP.project_points(torch.from_numpy(pts), torch.from_numpy(ext),
                               torch.from_numpy(k), W, H, require_positive_depth=positive)
    return (np.asarray(jp), np.asarray(jv)), (pp.numpy(), pv.numpy())


@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("positive", [False, True])
def test_project_points_equals_jax(per_frame, positive):
    (jpix, jvis), (pix, vis) = both_projections(points(0), cameras(), intrinsics(per_frame),
                                                positive)
    assert pix.shape == (F, 60, 2) and vis.shape == (F, 60) and vis.dtype == bool
    np.testing.assert_allclose(pix, jpix, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(vis, jvis)
    assert vis[0].any() and not vis[-1].any()
    # a point behind the camera can count as visible unless positive depth is asked for
    assert vis[:, :5].any() != positive


def _tier_cases():
    (_, _), (pix, vis) = both_projections(points(1), cameras(), intrinsics(False), True)
    none = np.zeros_like(vis)
    return {
        "A": (pix, vis, [0, 1, 2, 3]),
        "A_capped": (np.concatenate([pix] * 2), np.concatenate([vis] * 2), list(range(8))),
        "B": (pix, np.concatenate([np.zeros_like(vis[:1]), vis[1:]]), [0]),
        "C": (pix + 10_000, none, [3, 1]),
    }


@pytest.mark.parametrize("case", ["A", "A_capped", "B", "C"])
def test_view_tiers_equal_jax(case):
    pix, vis, rank = _tier_cases()[case]
    want = JP.select_view_crops(pix, vis, rank, W, H, max_views=5)
    got = PP.select_view_crops(pix, vis, rank, W, H, max_views=5)
    assert [vars(c) for c in got] == [vars(c) for c in want]
    assert {c.tier for c in want} == {case[0]}
    for f in np.flatnonzero(vis.any(-1)):
        assert PP.crop_box(pix[f][vis[f]], W, H) == JP.crop_box(pix[f][vis[f]], W, H)


def test_process_scene_files_equal_jax(tmp_path):
    """Saved mean features bit-equal, the quality log equal (crops and full
    frames encoded, each view L2-normalised before the mean)."""
    rng = np.random.RandomState(2)
    pts = np.concatenate([points(3, 80), points(4, 50) + [0.3, 0.0, 0.5],
                          rng.rand(30, 3).astype(np.float32) + 40]).astype(np.float32)
    inst = np.concatenate([np.full(80, 7), np.full(50, 9), np.full(30, 4)]).astype(np.int32)
    images = [rng.randint(0, 255, (H, W, 3), dtype=np.uint8) for _ in range(F)]
    names = {7: "chair", 9: "table", 4: "lamp", 11: "absent"}
    rank = {"chair": [3, 1, 0], "table": [3]}
    outs = {}
    for pkg, mod, kw in (("jax", JP, {}), ("port", PP, {"device": "cpu"})):
        ex = mod.MultiViewFeatureExtractor(hash_image_encoder, **kw)
        for _ in range(2):  # the log is appended to
            outs[pkg] = ex.process_scene(pts, inst, names, images, cameras(), intrinsics(False),
                                         rank, W, H, save_dir=str(tmp_path / pkg))
    assert sorted(outs["port"]) == sorted(outs["jax"]) == [4, 7, 9]
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert "instance_7_class_chair_origin_view_mean.npy" in files
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    log = (tmp_path / "port" / "project_quality.txt").read_text().splitlines()
    assert len(log) == 6 and "instance 4 class lamp tier C" in log


def test_build_multiview_features_equals_jax(tmp_path, monkeypatch):
    """The view-file regex, the croped/origin means and the listing; the
    hash encoder keys on the view path, so both tools run on one tree."""
    scans = tmp_path / "scans"
    views = {"scana": ["instance_3_class_trash can_view0_x_A.jpg",
                       "instance_3_class_trash can_croped_view0_x_A.jpg",
                       "instance_3_class_trash can_view1_x_B.jpg",
                       "instance_5_class_chair_view0_x_C.jpg", "notes.txt"],
             "scanb": ["instance_12_class_wall_croped_view2_y_B.jpg"]}
    for scan, names in views.items():
        (scans / scan / "multi_view").mkdir(parents=True)
        for name in names:
            (scans / scan / "multi_view" / name).write_bytes(b"")
    (tmp_path / "list.txt").write_text("scana\nscanb\nscanc")
    spec = importlib.util.spec_from_file_location(
        "jax_mv_tool", REPO / "tools" / "build_multiview_features.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    from vlsat_tpu_torch.tools.build_multiview_features import main as port_tool

    argv = ["--scans-root", str(scans), "--scan-list", str(tmp_path / "list.txt"),
            "--encoder", "hash", "--dim", "32"]
    monkeypatch.setattr(sys, "argv", ["t", *argv, "--out-list", str(tmp_path / "jax.txt")])
    jax_tool.main()
    want = {p: p.read_bytes() for p in sorted(scans.rglob("*.npy"))}
    for p in want:
        p.unlink()
    lines = port_tool([*argv, "--out-list", str(tmp_path / "port.txt")])
    got = {p: p.read_bytes() for p in sorted(scans.rglob("*.npy"))}
    assert list(got) == list(want) and len(want) == 4
    assert all(got[p] == want[p] for p in want)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert "Scene: scana Instance: 3 Label: trash can Quanlity: A" in lines
    with pytest.raises(NotImplementedError, match="transformers"):
        port_tool([*argv[:4], "--out-list", str(tmp_path / "x.txt")])
    shutil.rmtree(scans)

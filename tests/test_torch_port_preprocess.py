"""The port's offline preprocessing against the JAX package's, on the CPU:
depth back-projection and visibility (``preprocess/depth.py``), rescan
alignment (``preprocess/transform.py`` and ``tools/align_scans.py``) and the
scene splitting of ``preprocess/gen_data.py``.

Both packages get the same seeded numpy inputs.  Gates: the back-projection
at the parity gate of tests/test_parity_torch.py (fp32, rtol 1e-3, atol
1e-4); instance assignments, visible-instance lists, groups, mappings,
relationship entries and aligned PLY files exactly equal, with the
``np.random.RandomState`` left in the same state.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsat_tpu.data.ply import write_ply_vertices
from vlsat_tpu.preprocess import depth as JD
from vlsat_tpu.preprocess import gen_data as JG
from vlsat_tpu.preprocess import transform as JT
from vlsat_tpu_torch.preprocess import depth as PD
from vlsat_tpu_torch.preprocess import gen_data as PG
from vlsat_tpu_torch.preprocess import transform as PT

RTOL, ATOL = 1e-3, 1e-4
REPO = Path(__file__).resolve().parents[1]
H, W = 48, 64  # a depth map; the 3RScan one is 224 x 172
K = np.asarray([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)


def look_at(eye, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """camera -> world pose of a camera at ``eye`` looking at ``target``
    (x right, y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([x, y, z], axis=1)
    pose[:3, 3] = eye
    return pose.astype(np.float32)


def labelled_scene(seed: int, n_inst: int = 5, per: int = 300):
    rng = np.random.RandomState(seed)
    pts, lab = [], []
    for i in range(1, n_inst + 1):
        pts.append(rng.randn(3) * 1.5 + rng.randn(per, 3) * 0.3)
        lab.append(np.full(per, i, np.int32))
    return np.concatenate(pts).astype(np.float32), np.concatenate(lab)


def render_depth(points: np.ndarray, pose: np.ndarray, k: np.ndarray, h: int, w: int):
    """A z-buffered depth map of ``points`` (0 where nothing projects)."""
    w2c = np.linalg.inv(pose.astype(np.float64))
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    front = cam[:, 2] > 0.1
    uv = cam[front] @ k.astype(np.float64).T
    u = np.floor(uv[:, 0] / uv[:, 2]).astype(np.int64)
    v = np.floor(uv[:, 1] / uv[:, 2]).astype(np.int64)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.full((h, w), np.inf)
    np.minimum.at(depth, (v[ok], u[ok]), cam[front][ok, 2])
    depth[np.isinf(depth)] = 0
    return depth.astype(np.float32)


def poses(n: int, radius: float = 6.0):
    return [look_at((radius * np.cos(a), radius * np.sin(a), 1.5))
            for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]


# ------------------------------------------------------------------ depth

@pytest.mark.parametrize("seed", [0, 1])
def test_backproject_depth_equals_jax(seed):
    pts, _ = labelled_scene(seed)
    pose = poses(3)[seed]
    depth = render_depth(pts, pose, K, H, W)
    assert (depth > 0).sum() > 50 and (depth == 0).any()
    want = np.asarray(JD.backproject_depth(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(pose)))
    got = PD.backproject_depth(torch.from_numpy(depth), torch.from_numpy(K),
                               torch.from_numpy(pose))
    assert got.shape == (H * W, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # zero depth -> the camera origin
    np.testing.assert_allclose(got.numpy()[depth.reshape(-1) == 0], np.broadcast_to(
        pose[:3, 3], ((depth == 0).sum(), 3)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("max_dist,chunk", [(0.1, 2048), (0.05, 37), (10.0, 64)])
def test_nearest_instance_equals_jax(max_dist, chunk):
    pts, lab = labelled_scene(3)
    rng = np.random.RandomState(4)
    q = (pts[rng.choice(len(pts), 400)] + rng.randn(400, 3).astype(np.float32) * 0.06)
    q = np.concatenate([q, pts[:5], rng.randn(20, 3).astype(np.float32) * 9]).astype(np.float32)
    # a duplicated point with another label: the tie goes to the first index
    pts_tie = np.concatenate([pts, pts[:50]])
    lab_tie = np.concatenate([lab, np.full(50, 99, np.int32)])
    want = JD.nearest_instance(q, pts_tie, lab_tie, max_dist, chunk)
    got = PD.nearest_instance(q, pts_tie, lab_tie, max_dist, chunk, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any() and not (want == 99).any()


@pytest.mark.parametrize("stride,min_pixels", [(8, 50), (4, 20), (1, 1)])
def test_visible_instances_per_frame_equals_jax(stride, min_pixels):
    """The stride-scaled intrinsic and the c * stride^2 >= min_pixels rule."""
    pts, lab = labelled_scene(5)
    hh, ww = 96, 128
    k = np.asarray([[100.0, 0, ww / 2, 0], [0, 100.0, hh / 2, 0], [0, 0, 1, 0]], np.float32)
    ps = poses(4)
    depths = [render_depth(pts, p, k[:, :3], hh, ww) for p in ps]
    want = JD.visible_instances_per_frame(depths, k, ps, pts, lab, min_pixels=min_pixels,
                                          stride=stride)
    got = PD.visible_instances_per_frame(depths, k, ps, pts, lab, min_pixels=min_pixels,
                                         stride=stride, device="cpu")
    assert got == want
    assert sum(map(len, want.values())) >= 4


# -------------------------------------------------------------- transform

def test_transform_and_align_equal_jax(tmp_path, monkeypatch):
    """``read_transform_matrices`` keyed by ``scan["reference"]``, the
    row-vector float64 transform, and both align tools' PLY files byte for
    byte (rescans transformed, references copied, existing outputs kept)."""
    rng = np.random.RandomState(6)
    mats = {}
    scans = [f"scan{i}" for i in range(4)]
    for sid in scans:
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        m[3, :3] = rng.randn(3)  # row-vector convention: translation in the last row
        mats[sid] = m
    meta = [{"reference": "ignored", "scans": [
        {"reference": sid, "transform": mats[sid].reshape(-1).tolist()} for sid in scans[:2]]},
        {"scans": [{"reference": scans[2]}]}]
    (tmp_path / "3RScan.json").write_text(json.dumps(meta))
    got_t = PT.read_transform_matrices(str(tmp_path / "3RScan.json"))
    want_t = JT.read_transform_matrices(str(tmp_path / "3RScan.json"))
    assert sorted(got_t) == sorted(want_t) == scans[:2]
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k])
    p = rng.randn(50, 3).astype(np.float32)
    np.testing.assert_array_equal(PT.apply_transform(p.astype(np.float64), mats["scan0"]),
                                  JT.apply_transform(p.astype(np.float64), mats["scan0"]))

    spec = importlib.util.spec_from_file_location("jax_align_tool", REPO / "tools" / "align_scans.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    from vlsat_tpu_torch.tools.align_scans import main as port_tool

    (tmp_path / "rescans.txt").write_text("\n".join(scans[:3]))
    (tmp_path / "refs.txt").write_text(scans[3])
    for sid in scans:
        d = tmp_path / "jax" / sid
        d.mkdir(parents=True)
        write_ply_vertices(str(d / "labels.instances.annotated.v2.ply"),
                           rng.randn(40, 3).astype(np.float32),
                           instances=np.arange(40, dtype=np.int32),
                           colors=rng.randint(0, 255, (40, 3)).astype(np.uint8))
    # an existing output is kept
    (tmp_path / "jax" / scans[1] / "labels.instances.align.annotated.v2.ply").write_bytes(b"x")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    argv = ["--scan3r-json", str(tmp_path / "3RScan.json"), "--rescans",
            str(tmp_path / "rescans.txt"), "--references", str(tmp_path / "refs.txt")]
    monkeypatch.setattr(sys, "argv", ["align_scans.py", "--scans-root",
                                      str(tmp_path / "jax"), *argv])
    jax_tool.main()
    assert port_tool(["--scans-root", str(tmp_path / "port"), *argv]) == 3
    for sid in scans:
        name = "labels.instances.align.annotated.v2.ply"
        got = (tmp_path / "port" / sid / name).read_bytes()
        assert got == (tmp_path / "jax" / sid / name).read_bytes(), sid
    raw = (tmp_path / "jax" / scans[3] / "labels.instances.annotated.v2.ply").read_bytes()
    assert (tmp_path / "port" / scans[3] / "labels.instances.align.annotated.v2.ply"
            ).read_bytes() == raw


# --------------------------------------------------------------- gen_data

def segmented_scene(seed: int, n_seg: int = 12, per: int = 60):
    rng = np.random.RandomState(seed)
    centers = rng.rand(n_seg, 3) * [6.0, 6.0, 1.0]
    pts = np.concatenate([c + rng.randn(per, 3) * 0.25 for c in centers]).astype(np.float32)
    segs = np.repeat(np.arange(1, n_seg + 1), per).astype(np.int32)
    segs[rng.rand(len(segs)) < 0.05] = 0
    return pts, segs


def _gen_case(mod, case: str, seed: int):
    pts, segs = segmented_scene(seed)
    rng = np.random.RandomState(seed + 100)
    names = {i: f"cls{i % 5}" for i in range(1, 13)}
    if case == "seeds":
        out = mod.sample_seed_points(pts, distance=1.0, rng=rng)
    elif case == "bbox":
        seeds = mod.sample_seed_points(pts, distance=1.5, rng=rng)
        out = mod.bbox_groups(pts, segs, seeds, bbox_distance=1.5, min_seg_per_group=2)
    elif case == "layered":
        graph = mod.build_neighbor_graph(pts, segs, radius=0.8, sample=32, rng=rng)
        seeds = mod.sample_seed_points(pts, distance=1.5, rng=rng)
        out = mod.layered_growth_groups(seeds, segs, graph, n_layers=2, min_seg_per_group=3)
    elif case in ("KNN", "BBOX"):
        out = mod.generate_groups(pts, segs, split_method=case, distance=1.5,
                                  bbox_distance=1.2, min_seg_per_group=2,
                                  neighbor_radius=0.8, rng=rng)
    elif case == "split":
        groups = mod.generate_groups(pts, segs, distance=1.5, min_seg_per_group=2, rng=rng)
        rels = [[int(a), int(b), 1, "near"] for a, b in rng.randint(1, 13, (30, 2)) if a != b]
        out = mod.split_scene_relationships("scanX", names, rels, groups)
    elif case == "map":
        pred = pts + rng.randn(*pts.shape).astype(np.float32) * 0.02
        pred_segs = np.where(segs > 0, (segs + rng.randint(0, 2, len(segs))) % 14, 0)
        out = mod.map_segments(pred, pred_segs, pts, segs, max_dist=0.1, occ_thres=0.5)
    elif case == "clean":
        labels = np.where(rng.rand(len(segs)) < 0.2, rng.randint(1, 4, len(segs)), segs % 7)
        out = mod.clean_gt_segment_labels(segs, labels, min_seg_size=8)
    elif case == "scannet":
        pred = pts + rng.randn(*pts.shape).astype(np.float32) * 0.03
        pred_segs = np.where(rng.rand(len(segs)) < 0.5, segs, segs + 20)
        named = {**names, 3: "none"}
        mapping, groups = mod.map_segments_scannet(pred, pred_segs, pts, segs, named,
                                                   max_dist=0.1, min_seg_size=20)
        out = (mapping, groups,
               mod.gen_scannet_relationships("scene0000_00", mapping, named, groups, split=2),
               mod.gen_scannet_relationships("scene0000_00", mapping, named, groups,
                                             target_segments=sorted(mapping)[::2]))
    elif case == "same_part":
        seg_to_gt = {int(s): int(g) for s, g in zip(range(1, 13), rng.randint(1, 5, 12))}
        out = (mod.same_part_relationships(seg_to_gt),
               mod.same_part_relationships(seg_to_gt, 3, "part of", target_segments=[1, 2, 5]))
    elif case == "split_ids":
        out = mod.train_valid_split([f"s{i}" for i in range(23)], valid_fraction=0.2,
                                    seed=seed)
    else:
        raise AssertionError(case)
    return out, rng.rand()


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["seeds", "bbox", "layered", "KNN", "BBOX", "split", "map",
                                  "clean", "scannet", "same_part", "split_ids"])
def test_gen_data_equals_jax(case, seed):
    """Each function on the same scene and draws: equal results, and the
    RandomState left where JAX leaves it (its next draw equal)."""
    want, want_next = _gen_case(JG, case, seed)
    got, got_next = _gen_case(PG, case, seed)
    _same(got, want)
    assert got_next == want_next
    if case in ("bbox", "layered", "KNN", "BBOX", "split", "map", "scannet"):
        assert want and (not isinstance(want, tuple) or want[0])


def test_generate_groups_refuses_unknown_method():
    pts, segs = segmented_scene(0)
    for mod in (JG, PG):
        with pytest.raises(ValueError, match="split_method"):
            mod.generate_groups(pts, segs, split_method="GRID")

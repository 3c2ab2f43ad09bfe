"""The port's host data modules against the JAX package's, on the CPU.

Config, asset readers, class/relation weights, the PLY reader and writer
(binary and ASCII, faces, normals), the native C++ parser and instance
preparer (against the JAX package's build of the same source and against
the NumPy path), runtime subgraph sampling and the neighbor graph, the
z-rotation augmentation, and ``SSGScenes.prepare`` / ``SceneLoader`` scene by
scene on the fabricated scans of tests/mini_data.py and on
``make_synthetic_split(write_ply=True)``.  Mirrors the cases of
tests/test_data_pipeline.py, test_native.py, test_runtime_sampling.py and
test_rgb_normal.py where they touch these modules.

Gates: integer, bool and ``obj_points`` fields bit-equal (the same NumPy
code and RandomState draws, or the same C++ source); the descriptor at the
repo's parity gate, rtol 1e-3 / atol 1e-4 (the NumPy path computes it with
each package's own tensor library), with the largest difference printed.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from tests.mini_data import ASSETS, make_mini_dataset
from vlsat_tpu import native as jnative
from vlsat_tpu.config import load_config as jax_load_config
from vlsat_tpu.data import assets as JA
from vlsat_tpu.data import augment as JG
from vlsat_tpu.data import ply as JP
from vlsat_tpu.data import sampling as JS
from vlsat_tpu.data import weights as JW
from vlsat_tpu.data.dataset import SceneLoader as JaxLoader
from vlsat_tpu.data.dataset import SSGScenes as JaxScenes
from vlsat_tpu.data.synthetic import make_synthetic_split as jax_split
from vlsat_tpu.preprocess.gen_data import build_neighbor_graph as jax_neighbor_graph
from vlsat_tpu_torch import native as tnative
from vlsat_tpu_torch.config import Config, DEFAULT_CONFIG, load_config
from vlsat_tpu_torch.data import assets as TA
from vlsat_tpu_torch.data import augment as TG
from vlsat_tpu_torch.data import ply as TP
from vlsat_tpu_torch.data import sampling as TS
from vlsat_tpu_torch.data import weights as TW
from vlsat_tpu_torch.data.dataset import SceneLoader, SSGScenes
from vlsat_tpu_torch.data.synthetic import make_synthetic_split

DESC_TOL = dict(rtol=1e-3, atol=1e-4)
PLY_NAME = "labels.instances.align.annotated.v2.ply"


def assert_prepared_equal(got: dict, want: dict, what: str = "") -> float:
    """Every field of one prepared scene; returns the largest descriptor
    difference (printed by the callers)."""
    assert sorted(got) == sorted(want), what
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        if k == "descriptor":
            np.testing.assert_allclose(g, w, err_msg=f"{what} {k}", **DESC_TOL)
            worst = max(worst, float(np.abs(g - w).max()) if g.size else 0.0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
    return worst


# ----------------------------------------------------------------- config

def test_config_defaults_equal_jax():
    from vlsat_tpu.config import DEFAULT_CONFIG as JAX_DEFAULTS

    assert DEFAULT_CONFIG == JAX_DEFAULTS
    assert "PRNG_IMPL" in DEFAULT_CONFIG and "COMPILE_CACHE_DIR" in DEFAULT_CONFIG


def test_jax_experiment_json_loads_unchanged(tmp_path):
    exp = {"NAME": "Mmgnet", "PRNG_IMPL": "threefry2x32", "COMPILE_CACHE_DIR": "",
           "EVAL_BATCH_SIZE": "auto", "Batch_Size": 4,
           "MODEL": {"N_LAYERS": 3, "WEIGHT_EDGE": "BG", "USE_RGB": True},
           "dataset": {"root": "/data/3dssg", "sample_in_runtime": True}}
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(exp))
    got = load_config(path, overrides={"SEED": 7})
    want = jax_load_config(str(path), overrides={"SEED": 7})
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.MODEL.N_LAYERS == 3 and got.dataset.num_points == 128 and got.SEED == 7
    with pytest.raises(ValueError, match="WEIGHT_EDGE"):
        load_config(overrides={"MODEL": {"WEIGHT_EDGE": "NOPE"}})
    with pytest.raises(AttributeError, match="NO_SUCH_KEY"):
        Config({"a": 1}).NO_SUCH_KEY


# ----------------------------------------------------------------- assets

@pytest.mark.parametrize("multi_rel", [True, False])
def test_index_and_weights_equal_jax_on_the_real_split(multi_rel):
    """The 548 scan-splits of assets/3dssg/relationships_validation.json."""
    got = TA.build_index(ASSETS, "validation_scans", multi_rel=multi_rel)
    want = JA.build_index(ASSETS, "validation_scans", multi_rel=multi_rel)
    assert got.class_names == want.class_names
    assert got.relation_names == want.relation_names
    assert len(got.scenes) == len(want.scenes) > 500
    for g, w in zip(got.scenes, want.scenes):
        assert (g.scan_id, g.scan, g.objects, g.relationships) == \
            (w.scan_id, w.scan, w.objects, w.relationships)
    data = TA.load_relationship_json(ASSETS, "validation_scans")
    scans = [s.scan for s in got.scenes]
    o_t, r_t = TW.count_occurrences(got.class_names, got.relation_names, data, scans)
    o_j, r_j = JW.count_occurrences(want.class_names, want.relation_names, data, scans)
    np.testing.assert_array_equal(o_t, o_j)
    np.testing.assert_array_equal(r_t, r_j)
    for counts in (o_t, r_t, np.zeros(3)):
        np.testing.assert_array_equal(TW.normalized_weights(counts, none_boost=not multi_rel),
                                      JW.normalized_weights(counts, none_boost=not multi_rel))
    assert TA.build_triplet_vocab(data, got.class_names, got.relation_names) == \
        JA.build_triplet_vocab(data, want.class_names, want.relation_names)


def test_asset_readers_equal_jax(tmp_path):
    root, _ = make_mini_dataset(tmp_path)
    assert TA.read_classes(root) == JA.read_classes(root)
    assert TA.read_relationships(root) == JA.read_relationships(root)
    assert TA.read_scan_split(root, "train_scans") == JA.read_scan_split(root, "train_scans")
    assert TA.CORRUPT_SCANS == JA.CORRUPT_SCANS
    semseg = tmp_path / "semseg.v2.json"
    semseg.write_text(json.dumps({"segGroups": [
        {"id": 1, "label": "Chair"}, {"id": 2, "label": "wall"}, {"id": 5, "label": "Lamp"}]}))
    mapping = {"Chair": "chair", "wall": "wall"}
    for kw in ({}, {"name_mapping_dict": mapping},
               {"name_mapping_dict": mapping, "mapping": False}):
        assert TA.load_semseg(str(semseg), **kw) == JA.load_semseg(str(semseg), **kw)


# -------------------------------------------------------------------- ply

def _write_ascii_ply(path, pts, inst, colors, faces):
    head = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
            "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green", "property uchar blue",
            "property int objectId", f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    rows = [f"{p[0]!r} {p[1]!r} {p[2]!r} {c[0]} {c[1]} {c[2]} {i}"
            for p, c, i in zip(pts.tolist(), colors.tolist(), inst.tolist())]
    rows += [f"3 {a} {b} {c}" for a, b, c in faces.tolist()]
    path.write_text("\n".join(head + rows) + "\n")


def _mesh(seed=0, v=60, f=80):
    rng = np.random.RandomState(seed)
    pts = rng.randn(v, 3).astype(np.float32)
    inst = rng.randint(0, 5, v).astype(np.int32)
    colors = rng.randint(0, 256, (v, 3)).astype(np.uint8)
    normals = rng.randn(v, 3).astype(np.float32)
    faces = rng.randint(0, v, (f, 3)).astype(np.int32)
    return pts, inst, colors, normals, faces


def _assert_ply_equal(got, want):
    for k in ("points", "instances", "colors", "normals", "faces"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
def test_ply_read_equals_jax(tmp_path, fmt):
    pts, inst, colors, normals, faces = _mesh()
    path = tmp_path / f"{fmt}.ply"
    if fmt == "binary":
        TP.write_ply_vertices(str(path), pts, instances=inst, colors=colors, normals=normals,
                              faces=faces)
        twin = tmp_path / "jax.ply"
        JP.write_ply_vertices(str(twin), pts, instances=inst, colors=colors, normals=normals,
                              faces=faces)
        assert path.read_bytes() == twin.read_bytes()
    else:
        _write_ascii_ply(path, pts, inst, colors, faces)
    for with_faces in (False, True):
        got = TP.read_ply_vertices(str(path), with_faces=with_faces)
        _assert_ply_equal(got, JP.read_ply_vertices(str(path), with_faces=with_faces))
        np.testing.assert_array_equal(got.points, pts)
        np.testing.assert_array_equal(got.instances, inst)
        np.testing.assert_array_equal(got.colors, colors)
    np.testing.assert_array_equal(got.faces, faces)


def test_ply_rejects_what_it_cannot_read(tmp_path):
    bad = tmp_path / "be.ply"
    bad.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 0\n"
                    b"property float x\nend_header\n")
    with pytest.raises(NotImplementedError, match="binary_big_endian"):
        TP.read_ply_vertices(str(bad))


def test_vertex_normals_equal_jax():
    pts, _, _, _, faces = _mesh(seed=3, v=40, f=70)
    np.testing.assert_array_equal(TP.compute_vertex_normals(pts, faces),
                                  JP.compute_vertex_normals(pts, faces))
    quad = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [5, 5, 5]], np.float32)
    n = TP.compute_vertex_normals(quad, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    np.testing.assert_allclose(n[:4], [[0, 0, 1]] * 4, atol=1e-6)
    np.testing.assert_array_equal(n[4], [0, 0, 0])  # unreferenced vertex


# ----------------------------------------------------------------- native

@pytest.fixture(scope="module")
def libs():
    tlib, jlib = tnative.load(), jnative.load()
    if tlib is None or jlib is None:
        pytest.skip("no g++ to build the native parser")
    return tlib, jlib


def test_native_builds_into_the_port_tree(libs):
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "vlsat_tpu_torch"


def test_native_read_ply_equals_jax_and_numpy(libs, tmp_path):
    tlib, jlib = libs
    pts, inst, colors, normals, _ = _mesh(seed=1, v=500)
    path = str(tmp_path / "scan.ply")
    TP.write_ply_vertices(path, pts, instances=inst, colors=colors, normals=normals)
    got_p, got_i = tlib.read_ply(path)
    want_p, want_i = jlib.read_ply(path)
    ref = TP.read_ply_vertices(path)
    for g, w in ((got_p, want_p), (got_i, want_i), (got_p, ref.points), (got_i, ref.instances)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ascii_path = tmp_path / "ascii.ply"
    _write_ascii_ply(ascii_path, pts[:5], inst[:5], colors[:5], np.zeros((0, 3), np.int32))
    with pytest.raises(IOError):  # the native parser reads binary only
        tlib.read_ply(str(ascii_path))


def test_native_prepare_equals_jax_and_its_semantics(libs):
    tlib, jlib = libs
    rng = np.random.RandomState(1)
    pts = rng.randn(300, 3).astype(np.float32) * 2
    inst = np.repeat(np.arange(1, 4), 100).astype(np.int32)
    got_pts, got_desc = tlib.prepare_instances(pts, inst, [1, 2, 3], num_points=64, seed=7)
    want_pts, want_desc = jlib.prepare_instances(pts, inst, [1, 2, 3], num_points=64, seed=7)
    np.testing.assert_array_equal(got_pts, want_pts)
    np.testing.assert_array_equal(got_desc, want_desc)
    from vlsat_tpu_torch.data.dataset import _descriptor_np

    for n, iid in enumerate((1, 2, 3)):
        raw = got_pts[n] + got_desc[n, :3]  # undo the zero-mean
        pool = pts[inst == iid]
        assert max(np.abs(pool - r).sum(-1).min() for r in raw) < 1e-4
        np.testing.assert_allclose(got_pts[n].mean(0), 0, atol=1e-4)
        np.testing.assert_allclose(got_desc[n], _descriptor_np(raw), rtol=1e-4, atol=1e-4)
    other, _ = tlib.prepare_instances(pts, inst, [1, 2, 3], 64, seed=8)
    assert np.abs(other - got_pts).max() > 0
    with pytest.raises(ValueError):
        tlib.prepare_instances(pts, inst, [99], 64, seed=0)


# --------------------------------------------------------------- sampling

NNS = {1: [2, 3], 2: [1, 4], 3: [1], 4: [2, 5], 5: [4], 6: []}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_equals_jax(seed):
    for levels, n_seed in ((1, 1), (2, 2), (3, 1)):
        got = TS.bfs_neighbor_selection(NNS, list(NNS), levels, n_seed,
                                        np.random.RandomState(seed))
        want = JS.bfs_neighbor_selection(NNS, list(NNS), levels, n_seed,
                                         np.random.RandomState(seed))
        assert got == want
    str_keys = {str(k): v for k, v in NNS.items()}
    for cap in (-1, 1, 2):
        assert TS.edges_from_selection([1, 2, 3, 4, 5], str_keys, cap,
                                       np.random.RandomState(seed)) == \
            JS.edges_from_selection([1, 2, 3, 4, 5], str_keys, cap, np.random.RandomState(seed))
    edges = [[i, i + 1] for i in range(10)]
    assert TS.subsample_edges(edges, 4, np.random.RandomState(seed)) == \
        JS.subsample_edges(edges, 4, np.random.RandomState(seed))
    assert TS.subsample_edges(edges, -1) is edges
    with pytest.raises(KeyError, match="missing"):
        TS.edges_from_selection([7], NNS)


@pytest.mark.parametrize("radius", [0.3, 1.0, 3.0])
def test_neighbor_graph_equals_jax(radius):
    rng = np.random.RandomState(4)
    pts = np.concatenate([rng.randn(700, 3) * 0.4 + c for c in rng.randn(6, 3) * 2])
    seg = np.repeat(np.arange(0, 6), 700)  # segment 0 is the background
    got = TS.build_neighbor_graph(pts, seg, radius=radius, rng=np.random.RandomState(9))
    assert got == jax_neighbor_graph(pts, seg, radius=radius, rng=np.random.RandomState(9))
    assert sorted(got) == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------- augment

def test_augmentation_equals_jax():
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.randn(50, 3), rng.randn(50, 3)], axis=1).astype(np.float32)
    for offset in (None, 3):
        got = TG.random_z_rotation(pts, np.random.RandomState(1), normal_offset=offset)
        want = JG.random_z_rotation(pts, np.random.RandomState(1), normal_offset=offset)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TG.rotation_matrix([1, 2, 3], 0.7),
                                  JG.rotation_matrix([1, 2, 3], 0.7))
    np.testing.assert_array_equal(TG.rotation_matrix_from_vectors([1, 0, 0], [0, 1, 1]),
                                  JG.rotation_matrix_from_vectors([1, 0, 0], [0, 1, 1]))
    out = TG.random_z_rotation(pts, np.random.RandomState(1), normal_offset=3)
    np.testing.assert_allclose(np.linalg.norm(out[:, 3:], axis=1),
                               np.linalg.norm(pts[:, 3:], axis=1), rtol=1e-5)


# ----------------------------------------------------------------- scenes

def _with_channels(tmp_path, seed=7):
    """tests/test_rgb_normal.py's mini dataset: per-vertex colors, normals
    and a face list on every scan."""
    paths = make_mini_dataset(tmp_path)
    rng = np.random.RandomState(seed)
    for scan in sorted(os.listdir(tmp_path / "scans")):
        p = str(tmp_path / "scans" / scan / PLY_NAME)
        ply = JP.read_ply_vertices(p)
        v = len(ply.points)
        normals = rng.randn(v, 3).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        JP.write_ply_vertices(p, ply.points, instances=ply.instances,
                              colors=rng.randint(0, 256, (v, 3)).astype(np.uint8),
                              normals=normals,
                              faces=rng.randint(0, v, (2 * v, 3)).astype(np.int32))
    return paths


SCENE_CASES = {
    "default": dict(),
    "numpy_path": dict(use_native=False),
    "runtime_sampling": dict(sample_in_runtime=True, sample_num_nn=2, sample_num_seed=2,
                             neighbor_radius=20.0),
    "runtime_sampling_capped": dict(sample_in_runtime=True, sample_num_nn=1, sample_num_seed=3,
                                    max_edges=5, neighbor_radius=20.0),
    "union_points": dict(with_union_points=True),
    "augmentation": dict(use_data_augmentation=True, use_native=False),
    "annotated_edges": dict(all_edges=False),
    "single_label": dict(multi_rel=False),
    "rgb_normal": dict(use_rgb=True, use_normal=True, use_native=False),
    "rgb_union_augmented": dict(use_rgb=True, with_union_points=True,
                                use_data_augmentation=True),
}


@pytest.mark.parametrize("case", sorted(SCENE_CASES))
def test_prepare_equals_jax(tmp_path, case):
    kw = SCENE_CASES[case]
    if kw.get("use_rgb"):
        root, scans = _with_channels(tmp_path)
    else:
        root, scans = make_mini_dataset(tmp_path)
    cache = dict(cache_root=str(tmp_path / "cache_port")), dict(
        cache_root=str(tmp_path / "cache_jax"))
    port = SSGScenes(root, scans, "train_scans", num_points=16, **cache[0], **kw)
    ref = JaxScenes(root, scans, "train_scans", num_points=16, **cache[1], **kw)
    assert len(port) == len(ref) == 3
    np.testing.assert_array_equal(port.w_cls_obj, ref.w_cls_obj)
    np.testing.assert_array_equal(port.w_cls_rel, ref.w_cls_rel)
    assert port.dim_pts == ref.dim_pts
    worst = 0.0
    for draw in range(2):  # the second draw reads the npz mesh caches
        for i in range(len(port)):
            got = port.prepare(i, np.random.RandomState(10 * draw + i))
            want = ref.prepare(i, np.random.RandomState(10 * draw + i))
            worst = max(worst, assert_prepared_equal(got, want, f"{case} scene {i}"))
    print(f"{case}: largest descriptor difference {worst:.3g}")
    assert sorted(os.listdir(tmp_path / "cache_port")) == \
        sorted(os.listdir(tmp_path / "cache_jax"))


def test_prepare_uses_precomputed_neighbors(tmp_path):
    """tests/test_runtime_sampling.py:88-130: the 'neighbors' block of the
    relationships JSON decides the sampled edges (a line graph 1-2-3-4)."""
    root, scans = make_mini_dataset(tmp_path)
    with open(f"{root}/relationships_train.json") as f:
        data = json.load(f)
    scan0 = data["scans"][0]["scan"]
    data["neighbors"] = {scan0: {"1": [2], "2": [1, 3], "3": [2, 4], "4": [3]}}
    with open(f"{root}/relationships_train.json", "w") as f:
        json.dump(data, f)
    kw = dict(num_points=16, sample_in_runtime=True, sample_num_nn=2, sample_num_seed=1)
    port = SSGScenes(root, scans, "train_scans", **kw)
    ref = JaxScenes(root, scans, "train_scans", **kw)
    assert port._neighbor_graph(scan0, None, None) == {1: {2}, 2: {1, 3}, 3: {2, 4}, 4: {3}}
    edges = 0
    for seed in range(6):
        got = port.prepare(0, np.random.RandomState(seed))
        assert_prepared_equal(got, ref.prepare(0, np.random.RandomState(seed)))
        iids = got["gt_class"]  # scan 0's instance i carries class i
        for a, b in got["edge_index"]:
            assert abs(int(iids[a]) - int(iids[b])) == 1
        edges += len(got["edge_index"])
    assert edges > 0


def test_torn_mesh_cache_is_reparsed(tmp_path):
    """tests/test_data_pipeline.py:94-114: a torn npz cache file is parsed
    again and rewritten atomically."""
    root, scans = make_mini_dataset(tmp_path)
    cache = tmp_path / "cache"
    first = SSGScenes(root, scans, "train_scans", cache_root=str(cache))
    want = first.prepare(0, np.random.RandomState(0))
    files = sorted(cache / f for f in os.listdir(cache))
    assert files and all(f.suffix == ".npz" for f in files)
    for f in files:
        f.write_bytes(b"PK\x03\x04 not a complete zip")
    again = SSGScenes(root, scans, "train_scans", cache_root=str(cache))
    for i in range(len(again)):
        got = again.prepare(i, np.random.RandomState(0))
    assert_prepared_equal(again.prepare(0, np.random.RandomState(0)), want)
    for f in files:
        with np.load(f) as z:
            assert "points" in z
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(cache))


def test_scene_loader_equals_jax(tmp_path):
    """Shuffled training epochs with relation-free scenes resampled, and the
    sequential one-scene validation loader."""
    root, scans = make_mini_dataset(tmp_path)
    port = SSGScenes(root, scans, "train_scans", num_points=16)
    ref = JaxScenes(root, scans, "train_scans", num_points=16)
    for kw in (dict(batch_size=2, shuffle=True, for_train=True, seed=3),
               dict(batch_size=1, shuffle=False),
               dict(batch_size=2, shuffle=True, drop_last=True, buckets=(4, 8))):
        loader, jloader = SceneLoader(port, **kw), JaxLoader(ref, **kw)
        assert len(loader) == len(jloader)
        for epoch in range(2):
            got, want = list(loader), list(jloader)
            assert len(got) == len(want) and loader.epoch == epoch + 1
            for g, w in zip(got, want):
                for f in ("obj_points", "obj_mask", "gt_class", "edge_index", "edge_mask",
                          "gt_rels"):
                    np.testing.assert_array_equal(getattr(g, f).numpy(),
                                                  np.asarray(getattr(w, f)), err_msg=f)
                np.testing.assert_allclose(g.descriptor.numpy(), np.asarray(w.descriptor),
                                           **DESC_TOL)
                if kw.get("for_train"):
                    assert (g.gt_rels.numpy()[g.edge_mask.numpy()]).sum() > 0


def test_synthetic_split_equals_jax_and_prepares_alike(tmp_path):
    """``make_synthetic_split(write_ply=True)`` writes the JAX package's
    files byte for byte; its scans parse through the native reader."""
    kw = dict(num_scans=6, insts_per_scan=(4, 9), vertices_per_inst=50, rels_per_scan=(2, 6),
              seed=5, write_ply=True, background_verts=30)
    got = make_synthetic_split(str(tmp_path / "port"), **kw)
    want = jax_split(str(tmp_path / "jax"), **kw)
    for g, w in zip(got, want):
        files = sorted(os.path.relpath(os.path.join(d, f), g)
                       for d, _, fs in os.walk(g) for f in fs)
        assert files == sorted(os.path.relpath(os.path.join(d, f), w)
                               for d, _, fs in os.walk(w) for f in fs)
        for f in files:
            with open(os.path.join(g, f), "rb") as a, open(os.path.join(w, f), "rb") as b:
                assert a.read() == b.read(), f
    assert make_synthetic_split(str(tmp_path / "port"), **kw) == got  # reused
    port = SSGScenes(got[0], got[1], "validation_scans", cache_root=got[2])
    ref = JaxScenes(got[0], got[1], "validation_scans", cache_root=got[2] + "_jax")
    for i in range(len(port)):
        assert_prepared_equal(port.prepare(i, np.random.RandomState(i)),
                              ref.prepare(i, np.random.RandomState(i)), f"scene {i}")
    with pytest.raises(ValueError, match="node_counts"):
        make_synthetic_split(str(tmp_path / "bad"), num_scans=2, node_counts=[5])


def test_descriptor_matches_jax_on_raw_points():
    from vlsat_tpu.data.dataset import _descriptor_np as jax_descriptor
    from vlsat_tpu_torch.data.dataset import _descriptor_np

    rng = np.random.RandomState(0)
    for scale in (0.01, 1.0, 50.0):
        pts = (rng.randn(128, 3) * scale + rng.randn(3) * 3).astype(np.float32)
        got = _descriptor_np(pts)
        assert got.dtype == np.float32 and got.shape == (11,)
        np.testing.assert_allclose(got, jax_descriptor(pts), **DESC_TOL)
    assert torch.get_default_dtype() == torch.float32

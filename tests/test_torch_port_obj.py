"""The port's OBJ colour transfer (``data/obj.py``) against the JAX
package's, on the CPU: ``read_obj`` (polygon fans, every corner form, with
and without ``vn``), ``uv_to_color`` (PIL images of several modes, and the
port's decoded-array form), the three ``load_rgb`` routes (textured OBJ,
``color.align.ply``, ScanNet vertex-matched) and the ``max_dist`` refusal.

Both packages read the same seeded files.  Gate: every output exactly
equal (host NumPy in both).
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from vlsat_tpu.data import obj as JO
from vlsat_tpu.data.ply import write_ply_vertices
from vlsat_tpu_torch.data import obj as PO


def _same(got, want):
    for field in ("points", "instances", "colors", "normals", "faces"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is not None:
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def write_obj(path, rng, n: int = 30, normals: bool = True, mtllib: bool = True):
    """A random mesh: quads and triangles, corners as v, v/vt, v//vn, v/vt/vn."""
    lines = ["mtllib mesh.refined.mtl"] if mtllib else []
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in rng.rand(n, 3)]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in rng.rand(n, 2)]
    if normals:
        lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in rng.randn(n, 3)]
    for k in range(n - 3):
        ids = [k + 1, k + 2, k + 3] + ([k + 4] if k % 2 else [])
        if not normals:
            lines.append("f " + " ".join(f"{i}/{i}" for i in ids))
        elif k % 3 == 0:
            lines.append("f " + " ".join(f"{i}/{i}/{i}" for i in ids))
        elif k % 3 == 1:
            lines.append("f " + " ".join(f"{i}//{i}" for i in ids))
        else:
            lines.append("f " + " ".join(f"{i}/{i}" for i in ids))
    lines.append("# a comment\n")
    path.write_text("\n".join(lines))


@pytest.mark.parametrize("normals,mtllib", [(True, True), (False, False)])
def test_read_obj_equals_jax(tmp_path, normals, mtllib):
    write_obj(tmp_path / "m.obj", np.random.RandomState(0), normals=normals, mtllib=mtllib)
    got, want = PO.read_obj(str(tmp_path / "m.obj")), JO.read_obj(str(tmp_path / "m.obj"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w
    (tmp_path / "m.mtl").write_text("newmtl a\nKd 1 1 1\nmap_Kd tex 0.png\n")
    assert PO.read_mtl_texture(str(tmp_path / "m.mtl")) == JO.read_mtl_texture(
        str(tmp_path / "m.mtl")) == "0.png"


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_uv_to_color_equals_jax(mode):
    """Flipped v, nearest pixel, wrap-around; a decoded (H, W, 3|4) uint8
    array gives the PIL image's colours."""
    rng = np.random.RandomState(1)
    img = Image.fromarray(rng.randint(0, 255, (7, 9, 3), dtype=np.uint8)).convert(mode)
    uv = np.concatenate([rng.rand(40, 2) * 1.4 - 0.2, [[0, 0], [1, 1], [0, 1], [1, 0]]])
    want = JO.uv_to_color(uv, img)
    np.testing.assert_array_equal(PO.uv_to_color(uv, img), want)
    for arr in (np.asarray(img.convert("RGB")), np.asarray(img.convert("RGBA"))):
        np.testing.assert_array_equal(PO.uv_to_color(uv, arr), want)
    with pytest.raises(ValueError, match="uint8"):
        PO.uv_to_color(uv, np.zeros((7, 9), np.uint8))


def write_scan(tmp_path, rng, route: str, n: int = 30):
    """A scan directory of ``route`` ("obj", "obj_default_texture", "ply",
    "scannet"); the raw label mesh is the source mesh moved by 1e-5."""
    if route == "scannet":
        d = tmp_path / "scene0001_00"
        d.mkdir()
        pts = rng.randn(n, 3).astype(np.float32)
        faces = np.stack([np.arange(n - 2), np.arange(1, n - 1), np.arange(2, n)], 1)
        write_ply_vertices(str(d / "scene0001_00_vh_clean_2.ply"), pts,
                           colors=rng.randint(0, 255, (n, 3)).astype(np.uint8),
                           faces=faces.astype(np.int32))
        write_ply_vertices(str(d / JO.LABEL_FILE_NAME), pts,
                           instances=rng.randint(0, 4, n).astype(np.int32), faces=faces)
        return d
    d = tmp_path / "scan0"
    d.mkdir()
    if route == "ply":
        src = rng.rand(n, 3).astype(np.float32)
        write_ply_vertices(str(d / "color.align.ply"), src,
                           colors=rng.randint(0, 255, (n, 3)).astype(np.uint8),
                           normals=rng.randn(n, 3).astype(np.float32))
    else:
        write_obj(d / JO.OBJ_NAME, rng, n=n, normals=route == "obj")
        tex = "custom.png" if route == "obj" else JO.TEXTURE_NAME
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)).save(d / tex)
        if route == "obj":
            (d / JO.MTL_NAME).write_text(f"newmtl m\nmap_Kd {tex}\n")
        src = JO.read_obj(str(d / JO.OBJ_NAME))["points"]
    perm = rng.permutation(n)
    write_ply_vertices(str(d / JO.LABEL_FILE_NAME_RAW), src[perm] + 1e-5,
                       instances=rng.randint(0, 4, n).astype(np.int32))
    write_ply_vertices(str(d / JO.LABEL_FILE_NAME), src[perm] + [10.0, 0, 0],
                       instances=rng.randint(0, 4, n).astype(np.int32))
    return d


@pytest.mark.parametrize("route", ["obj", "obj_default_texture", "ply", "scannet"])
def test_load_rgb_equals_jax(tmp_path, route):
    d = write_scan(tmp_path, np.random.RandomState(2), route)
    want = JO.load_rgb(str(d))
    _same(PO.load_rgb(str(d)), want)
    assert want.colors is not None and want.normals is not None
    if route != "scannet":  # the nearest-vertex transfer within a bound
        _same(PO.load_rgb(str(d), max_dist=1e-3), JO.load_rgb(str(d), max_dist=1e-3))
        for mod in (JO, PO):
            with pytest.raises(ValueError, match="farther than"):
                mod.load_rgb(str(d), max_dist=1e-9)


def test_load_rgb_refusals_equal_jax(tmp_path):
    """No texture, no UVs, a vertex-count mismatch: both raise alike."""
    rng = np.random.RandomState(3)
    d = write_scan(tmp_path, rng, "obj_default_texture")
    (d / JO.TEXTURE_NAME).unlink()
    for mod in (JO, PO):
        with pytest.raises(FileNotFoundError, match="texture"):
            mod.load_rgb(str(d))
    s = write_scan(tmp_path, rng, "scannet")
    write_ply_vertices(str(s / JO.LABEL_FILE_NAME), np.zeros((3, 3), np.float32),
                       instances=np.ones(3, np.int32))
    for mod in (JO, PO):
        with pytest.raises(ValueError, match="vertex count mismatch"):
            mod.load_rgb(str(s))

"""ctypes loader for the native host data-loader core (counterpart of
``vlsat_tpu/native/__init__.py``).

``load()`` compiles ``native/ply_native.cpp`` with ``g++ -O3`` at first use
into ``vlsat_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, and returns a small wrapper; it returns None
when no toolchain is available, and callers then take the NumPy paths of
``data/ply.py`` and ``data/dataset.py``.  This is host code: nothing here
touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "ply_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_LIB: Optional["NativeLib"] = None
_TRIED = False


class NativeLib:
    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        dll.vlsat_read_ply.restype = ctypes.c_int
        dll.vlsat_read_ply.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        dll.vlsat_free.restype = None
        dll.vlsat_free.argtypes = [ctypes.c_void_p]
        dll.vlsat_prepare_instances.restype = ctypes.c_int
        dll.vlsat_prepare_instances.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]

    def read_ply(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        """(V, 3) float32 points and (V,) int32 instance ids of a binary
        little-endian PLY; raises IOError for anything else."""
        pts_p = ctypes.POINTER(ctypes.c_float)()
        inst_p = ctypes.POINTER(ctypes.c_int32)()
        n = ctypes.c_int64()
        rc = self._dll.vlsat_read_ply(path.encode(), ctypes.byref(pts_p),
                                      ctypes.byref(inst_p), ctypes.byref(n))
        if rc != 0:
            raise IOError(f"native PLY parse failed ({rc}) for {path}")
        try:
            count = n.value
            pts = np.ctypeslib.as_array(pts_p, shape=(count, 3)).copy()
            inst = np.ctypeslib.as_array(inst_p, shape=(count,)).copy()
        finally:
            self._dll.vlsat_free(pts_p)
            self._dll.vlsat_free(inst_p)
        return pts, inst

    def prepare_instances(self, points: np.ndarray, instances: np.ndarray,
                          node_ids, num_points: int,
                          seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per node: ``num_points`` samples with replacement (zero-meaned)
        and the 11-dim descriptor of the raw samples."""
        points = np.ascontiguousarray(points, np.float32)
        instances = np.ascontiguousarray(instances, np.int32)
        ids = np.ascontiguousarray(node_ids, np.int32)
        if points.ndim != 2 or points.shape[1] != 3 or len(instances) != len(points):
            raise ValueError(f"points {points.shape} / instances {instances.shape}: "
                             "want (V, 3) and (V,)")
        n = len(ids)
        out_pts = np.empty((n, num_points, 3), np.float32)
        out_desc = np.empty((n, 11), np.float32)
        rc = self._dll.vlsat_prepare_instances(
            points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            instances.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(points),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, num_points, seed,
            out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_desc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise ValueError("native prepare_instances failed (empty instance?)")
        return out_pts, out_desc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libvlsat_ply-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile to a per-process temporary name, then rename: concurrent
    test workers or pack workers never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> Optional[NativeLib]:
    """The loaded library, built on the first call; None without g++."""
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            _LIB = NativeLib(ctypes.CDLL(str(so)))
        except OSError:
            _LIB = None
        return _LIB

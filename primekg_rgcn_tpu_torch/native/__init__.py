"""ctypes bindings of the native graph builder (``graphbuild.cpp``).

The shared library is compiled at first use with the system C++ compiler
(``g++ -O3 -std=c++17 -shared -fPIC -pthread``) into
``primekg_rgcn_tpu_torch/_build/``, named by a hash of the source and the
flags, so a fresh checkout builds its own. ``data/graph.build_rel_graph``
takes it for large graphs; without a compiler it falls back to numpy unless
the caller asked for the native path (``use_native="always"``). Both paths
give bit-identical arrays (stable sorts). ``rmat_native`` generates the
R-MAT graph of ``data/synthetic.rmat`` in parallel, with its own random
streams (not numpy's draws).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "graphbuild.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
COMPILER = "g++"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the built library lives, keyed by a hash of source and
    flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgraphbuild_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [COMPILER, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native graph builder unavailable: %s", e)
        return False
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        logger.warning("native graph builder failed to build:\n%s",
                       r.stderr[-2000:])
        return False
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built first when needed), or None when it cannot
    be built or loaded. The first attempt's outcome is kept."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("failed to load the native graph builder: %s", e)
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.gb_count_buckets.restype = ctypes.c_int64
        lib.gb_count_buckets.argtypes = [i64p, i64p, i64p, i64, i64, i64,
                                         i64p]
        lib.gb_build_rel_graph.restype = ctypes.c_int32
        lib.gb_build_rel_graph.argtypes = [
            i64p, i64p, i64p, i64, i64, i64, i64p, i32p, i32p, i32p, i32p,
            f32p, ctypes.c_int32, f32p, f32p]
        lib.gb_rmat.restype = None
        lib.gb_rmat.argtypes = [i64, i64, i64, ctypes.c_uint64,
                                ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, i64p, i64p, i64p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _edges(src, dst, rel) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(np.ascontiguousarray(a, np.int64) for a in (src, dst, rel))


def count_buckets(lib: ctypes.CDLL, src, dst, rel, num_nodes: int,
                  num_relations: int) -> Tuple[np.ndarray, int]:
    """Valid edges per relation (int64[R]) and their total; an edge is
    valid when its node and relation ids are in range."""
    src, dst, rel = _edges(src, dst, rel)
    counts = np.zeros(num_relations, np.int64)
    valid = lib.gb_count_buckets(
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
        _ptr(rel, ctypes.c_int64), len(src), num_nodes, num_relations,
        _ptr(counts, ctypes.c_int64))
    return counts, int(valid)


def build_rel_graph_native(lib: ctypes.CDLL, src, dst, rel, num_nodes: int,
                           num_relations: int, caps,
                           *, norm_mode: str) -> Dict[str, np.ndarray]:
    """The bucket / sort / pad / degree arrays of ``data/graph.RelGraph``
    (without the CSR row pointers), from raw COO edges; invalid edges are
    dropped. Raises when a capacity is below its bucket's size."""
    src, dst, rel = _edges(src, dst, rel)
    caps = np.ascontiguousarray(caps, np.int64)
    total = int(caps.sum())
    out = {k: np.empty(total, np.int32)
           for k in ("src", "dst", "t_src", "t_dst")}
    edge_norm = norm_mode == "edge"
    dummy = np.zeros(1, np.float32)  # a valid pointer for unused outputs
    if edge_norm:
        out["inv_in_deg"] = np.zeros((0, 0), np.float32)
        out["edge_scale"] = np.empty(total, np.float32)
        out["t_edge_scale"] = np.empty(total, np.float32)
        bufs = (dummy, out["edge_scale"], out["t_edge_scale"])
    else:
        out["inv_in_deg"] = np.empty((num_relations, num_nodes + 1),
                                     np.float32)
        out["edge_scale"] = np.zeros(0, np.float32)
        out["t_edge_scale"] = np.zeros(0, np.float32)
        bufs = (out["inv_in_deg"], dummy, dummy)
    rc = lib.gb_build_rel_graph(
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
        _ptr(rel, ctypes.c_int64), len(src), num_nodes, num_relations,
        _ptr(caps, ctypes.c_int64), _ptr(out["src"], ctypes.c_int32),
        _ptr(out["dst"], ctypes.c_int32), _ptr(out["t_src"], ctypes.c_int32),
        _ptr(out["t_dst"], ctypes.c_int32), _ptr(bufs[0], ctypes.c_float),
        ctypes.c_int32(int(edge_norm)), _ptr(bufs[1], ctypes.c_float),
        _ptr(bufs[2], ctypes.c_float))
    if rc != 0:
        raise ValueError(f"native graph build failed (rc={rc}): a bucket "
                         "capacity is smaller than its bucket")
    return out


def rmat_native(num_nodes: int, num_edges: int, num_relations: int,
                seed: int = 0, a: float = 0.57, b: float = 0.19,
                c: float = 0.19) -> Optional[Dict[str, np.ndarray]]:
    """The R-MAT graph of ``data/synthetic.rmat`` (the same keys), drawn by
    ``gb_rmat`` on every host thread; None when the library is unavailable.
    Each thread's chunk seeds a Mersenne twister of its own, so one seed
    gives the same arrays again on the same machine, and the JAX package's
    ``rmat_native`` the same ones."""
    lib = get_lib()
    if lib is None:
        return None
    out = {k: np.empty(num_edges, np.int64) for k in ("src", "dst", "rel")}
    lib.gb_rmat(num_nodes, num_edges, num_relations, seed, a, b, c,
                _ptr(out["src"], ctypes.c_int64),
                _ptr(out["dst"], ctypes.c_int64),
                _ptr(out["rel"], ctypes.c_int64))
    return {**out, "num_nodes": num_nodes, "num_relations": num_relations}

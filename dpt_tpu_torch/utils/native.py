"""The port's native host runtime: BVH builds and the OBJ parser in C++.

Counterpart of `dpt_tpu/utils/native.py`, with the same three functions and
return contracts.  The source is the port's own copy,
`csrc/native_host.cpp` (byte-identical output to the numpy builders and the
pure-Python parser); it is compiled by `g++` at first use into
`dpt_tpu_torch/_build/`, under a name keyed by a hash of the source and the
flags, so an edited source is never served a stale build, and bound with
ctypes.  Nothing is built at import.

Failure rules, as the JAX package's "library absent -> numpy":
  - no `g++` on PATH: each function returns None after one line on
    standard error, and its caller falls back to numpy;
  - a failed compile raises, and so does a non-positive return code of the
    library: a present but failing runtime never falls back quietly.

`-ffp-contract=off` and no `-march`: no multiply-add is fused, so the SAH
costs round as numpy's do and the trees are the same on every host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "native_host.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared")

_LIB = None
# Wall seconds the last build took (0.0 when the library already existed).
build_seconds = 0.0
# Calls served by the native runtime, per function (reset by the caller).
calls = {"build_bvh": 0, "build_bvh_sah": 0, "load_obj": 0}


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdpt_native_host_{h.hexdigest()[:16]}.so"


def build(cxx: str) -> pathlib.Path:
    """Compile the source into the keyed library unless it exists; raise
    with the compiler's output when the compile fails."""
    global build_seconds
    out = library_path()
    build_seconds = 0.0
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def _lib():
    """The built library with its argtypes, or None without `g++`."""
    global _LIB
    if _LIB is not None:
        return _LIB
    cxx = shutil.which("g++")
    if cxx is None:
        print("dpt_tpu_torch: no g++ on PATH, the native host runtime is "
              "not built; using the numpy builders and parser",
              file=sys.stderr, flush=True)
        return None
    lib = ctypes.CDLL(str(build(cxx)))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    i = ctypes.c_int
    # vertices, V, indices, T, leaf_size, [n_bins,] node_min, node_max,
    # node_left, node_right, tri_order
    lib.dpt_build_bvh.argtypes = [fp, i, ip, i, i, fp, fp, ip, ip, ip]
    lib.dpt_build_bvh_sah.argtypes = [fp, i, ip, i, i, i, fp, fp, ip, ip,
                                      ip]
    # path, out n_vertices, out n_triangles
    lib.dpt_load_obj_counts.argtypes = [ctypes.c_char_p, ip, ip]
    # path, out vertices, indices, uvs [T*3*2], mat_idx [T]
    lib.dpt_load_obj_fill.argtypes = [ctypes.c_char_p, fp, ip, fp, ip]
    for f in (lib.dpt_build_bvh, lib.dpt_build_bvh_sah,
              lib.dpt_load_obj_counts, lib.dpt_load_obj_fill):
        f.restype = i
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the native runtime can run here (builds it on first call)."""
    return _lib() is not None


def _build_tree(name, vertices, indices, leaf_size, *extra):
    lib = _lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    n_tri = idx.shape[0]
    max_nodes = max(2 * n_tri - 1, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_left = np.empty(max_nodes, np.int32)
    node_right = np.empty(max_nodes, np.int32)
    tri_order = np.empty(n_tri, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n_nodes = getattr(lib, f"dpt_{name}")(
        v.ctypes.data_as(fp), v.shape[0], idx.ctypes.data_as(ip), n_tri,
        leaf_size, *extra,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        node_left.ctypes.data_as(ip), node_right.ctypes.data_as(ip),
        tri_order.ctypes.data_as(ip),
    )
    if n_nodes <= 0:
        raise RuntimeError(f"native {name} failed (rc={n_nodes}) for "
                           f"{n_tri} triangles")
    calls[name] += 1
    return (node_min[:n_nodes], node_max[:n_nodes], node_left[:n_nodes],
            node_right[:n_nodes], tri_order)


def native_build_bvh(vertices: np.ndarray, indices: np.ndarray,
                     leaf_size: int):
    """Median-split twin of accel/bvh.build_bvh_median, byte for byte:
    (node_min, node_max, node_left, node_right, tri_order) numpy arrays, or
    None without `g++`."""
    return _build_tree("build_bvh", vertices, indices, leaf_size)


def native_build_bvh_sah(vertices: np.ndarray, indices: np.ndarray,
                         leaf_size: int, n_bins: int = 16):
    """Binned-SAH twin of accel/bvh.build_bvh_sah, byte for byte: the same
    arrays, or None without `g++`."""
    return _build_tree("build_bvh_sah", vertices, indices, leaf_size, n_bins)


def native_load_obj(path: str):
    """(vertices [V, 3] f32, indices [T, 3] i32, uvs [T, 3, 2] f32,
    mat_idx [T] i32) of an OBJ file, as scene/obj.py's parser gives them,
    or None without `g++`."""
    lib = _lib()
    if lib is None:
        return None
    nv, nt = ctypes.c_int(), ctypes.c_int()
    if lib.dpt_load_obj_counts(os.fsencode(path), ctypes.byref(nv),
                               ctypes.byref(nt)) != 0:
        raise RuntimeError(f"native OBJ parse failed for {path!r}")
    V, T = nv.value, nt.value
    vertices = np.empty((V, 3), np.float32)
    indices = np.empty((T, 3), np.int32)
    uvs = np.empty((T, 3, 2), np.float32)
    mat_idx = np.empty(T, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    if lib.dpt_load_obj_fill(
            os.fsencode(path), vertices.ctypes.data_as(fp),
            indices.ctypes.data_as(ip), uvs.ctypes.data_as(fp),
            mat_idx.ctypes.data_as(ip)) != 0:
        raise RuntimeError(f"native OBJ fill failed for {path!r}")
    calls["load_obj"] += 1
    return vertices, indices, uvs, mat_idx

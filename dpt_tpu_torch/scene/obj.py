"""Wavefront OBJ loader -> flat numpy arrays.

A copy of the pure-Python parser of `dpt_tpu/scene/obj.py` (numpy only).
As in the JAX package, `load_obj(use_native=True)` parses the geometry with
the native runtime (utils/native.py, the port's own C++ build: the same
arrays byte for byte) and scans only the material statements in Python;
without `g++` the pure-Python parser runs.  Replaces the reference's
tiny_obj_loader.h + the flattening in VulkanRayTracer.cpp:64-92.

Supported: v / vt / f (triangles and arbitrary polygons by fan
triangulation, tinyobjloader's default), negative (relative) indices,
usemtl -> per-triangle material ids, mtllib with Kd diffuse parsing.  Lines
not modelled (vn, o, g, s, vp, l) are skipped.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjMesh:
    vertices: np.ndarray  # [V, 3] float32
    indices: np.ndarray  # [T, 3] int32 position indices
    uvs: np.ndarray  # [T, 3, 2] float32 per-corner texcoords (0 where absent)
    mat_idx: np.ndarray  # [T] int32
    material_names: list = field(default_factory=list)
    material_albedo: np.ndarray = None  # [M, 3] float32 (Kd; 0.8 default)


def _resolve(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative counts from the end."""
    return idx - 1 if idx > 0 else count + idx


def _parse_mtl(path: str) -> dict:
    """name -> Kd rgb from a .mtl file (best effort: a missing file gives
    no entries)."""
    albedos = {}
    cur = None
    try:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "newmtl" and len(parts) > 1:
                    cur = parts[1]
                elif parts[0] == "Kd" and cur and len(parts) >= 4:
                    albedos[cur] = [float(p) for p in parts[1:4]]
    except OSError:
        pass
    return albedos


def _scan_materials(path: str):
    """usemtl order + mtllib Kd values (the only parts the native geometry
    parser leaves to Python)."""
    names: list = []
    kd: dict = {}
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "usemtl" and len(parts) > 1:
                if parts[1] not in names:
                    names.append(parts[1])
            elif parts[0] == "mtllib" and len(parts) > 1:
                kd.update(_parse_mtl(os.path.join(base_dir, parts[1])))
    return names, kd


def _material_table(mat_names, mat_kd, default_albedo):
    n_mat = max(len(mat_names), 1)
    albedo = np.tile(np.asarray(default_albedo, np.float32), (n_mat, 1))
    for m, name in enumerate(mat_names):
        if name in mat_kd:
            albedo[m] = mat_kd[name]
    return albedo


def load_obj(path: str, default_albedo=(0.8, 0.8, 0.8),
             use_native: bool = True) -> ObjMesh:
    if use_native:
        from dpt_tpu_torch.utils.native import native_load_obj

        native = native_load_obj(path)  # None only without g++
        if native is not None:
            vertices, indices, uvs, mat_idx = native
            mat_names, mat_kd = _scan_materials(path)
            return ObjMesh(
                vertices=vertices,
                indices=indices,
                uvs=uvs,
                mat_idx=mat_idx,
                material_names=mat_names,
                material_albedo=_material_table(mat_names, mat_kd,
                                                default_albedo),
            )

    positions: list = []
    texcoords: list = []
    faces: list = []  # (corners ((pos_idx, uv_idx or None) x 3), mat_id)
    mat_names: list = []
    mat_kd: dict = {}
    cur_mat = -1

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            elif tag == "vt":
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                texcoords.append([u, v])
            elif tag == "f":
                corners = []
                for spec in parts[1:]:
                    comps = spec.split("/")
                    pi = _resolve(int(comps[0]), len(positions))
                    ti = None
                    if len(comps) > 1 and comps[1]:
                        ti = _resolve(int(comps[1]), len(texcoords))
                    corners.append((pi, ti))
                # Fan triangulation (tinyobjloader default for quads/ngons).
                for k in range(1, len(corners) - 1):
                    faces.append(((corners[0], corners[k], corners[k + 1]),
                                  cur_mat))
            elif tag == "usemtl" and len(parts) > 1:
                name = parts[1]
                if name not in mat_names:
                    mat_names.append(name)
                cur_mat = mat_names.index(name)
            elif tag == "mtllib" and len(parts) > 1:
                mat_kd.update(_parse_mtl(os.path.join(base_dir, parts[1])))

    n_tri = len(faces)
    vertices = np.asarray(positions, np.float32).reshape(-1, 3)
    indices = np.zeros((n_tri, 3), np.int32)
    uvs = np.zeros((n_tri, 3, 2), np.float32)
    mat_idx = np.zeros((n_tri,), np.int32)
    tex = (np.asarray(texcoords, np.float32).reshape(-1, 2) if texcoords
           else None)
    for t, (tri, mat) in enumerate(faces):
        for c, (pi, ti) in enumerate(tri):
            indices[t, c] = pi
            if ti is not None and tex is not None:
                uvs[t, c] = tex[ti]
        mat_idx[t] = max(mat, 0)  # VulkanRayTracer.cpp:90: negative -> 0

    return ObjMesh(
        vertices=vertices,
        indices=indices,
        uvs=uvs,
        mat_idx=mat_idx,
        material_names=mat_names,
        material_albedo=_material_table(mat_names, mat_kd, default_albedo),
    )


def write_obj(path: str, vertices: np.ndarray, indices: np.ndarray):
    """Minimal OBJ writer (positions and triangles)."""
    with open(path, "w") as f:
        f.write("# dpt_tpu_torch export\n")
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in np.asarray(indices):
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")

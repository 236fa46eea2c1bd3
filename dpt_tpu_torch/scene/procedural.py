"""Procedural meshes: unit cube + a Sylveon-class high-poly stand-in.

A copy of `dpt_tpu/scene/procedural.py` (numpy only), so both packages
build byte-identical meshes.

The reference's showcase asset `scenes/Sylveon.obj` is stripped from the
snapshot (.MISSING_LARGE_BLOBS); `bumpy_sphere` generates a displaced UV
sphere of comparable triangle count for configs 3-5.  `box_mesh` reproduces
the Blender default cube of scenes/box.obj (8 verts at ±1, 6 quads → 12 tris
after fan triangulation) without parsing the reference asset.
"""

from __future__ import annotations

import numpy as np


def box_mesh():
    """Axis-aligned ±1 cube, quads fan-triangulated like tinyobjloader.

    Returns (vertices [8,3] f32, indices [12,3] i32).
    """
    v = np.array(
        [
            [1, 1, -1],
            [1, -1, -1],
            [1, 1, 1],
            [1, -1, 1],
            [-1, 1, -1],
            [-1, -1, -1],
            [-1, 1, 1],
            [-1, -1, 1],
        ],
        np.float32,
    )
    # Six quads (outward-facing, Blender cube winding), 0-based.
    quads = np.array(
        [
            [0, 4, 6, 2],  # +Y
            [3, 2, 6, 7],  # +Z
            [7, 6, 4, 5],  # -X
            [5, 1, 3, 7],  # -Y
            [1, 0, 2, 3],  # +X
            [5, 4, 0, 1],  # -Z
        ],
        np.int32,
    )
    tris = []
    for q in quads:
        tris.append([q[0], q[1], q[2]])
        tris.append([q[0], q[2], q[3]])
    return v, np.asarray(tris, np.int32)


def bumpy_sphere(n_lat: int = 128, n_lon: int = 256, radius: float = 1.0,
                 bump: float = 0.15, seed: int = 0):
    """Displaced UV sphere — Sylveon-class stand-in.

    Triangle count = 2 * (n_lat - 1) * n_lon (minus pole degenerates pruned).
    Default ≈ 65k triangles; n_lat=256,n_lon=512 ≈ 260k.
    Returns (vertices [V,3] f32, indices [T,3] i32).
    """
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")  # [n_lat+1, n_lon]
    # Smooth multi-frequency displacement (deterministic).
    r = radius * (
        1.0
        + bump * np.sin(5 * theta) * np.cos(7 * phi + seed)
        + 0.5 * bump * np.sin(11 * phi) * np.sin(3 * theta + seed)
    )
    x = r * np.sin(theta) * np.cos(phi)
    y = r * np.cos(theta)
    z = r * np.sin(theta) * np.sin(phi)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    tris = []
    # Outward-facing winding (the integrator shades with unflipped geometric
    # normals, matching raytrace_comp.comp:189 — inward winding renders black).
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            if i > 0:  # skip degenerate top-pole fan halves
                tris.append([a, d, b])
            if i < n_lat - 1:
                tris.append([b, d, c])
    return verts, np.asarray(tris, np.int32)


def torus_knot(p: int = 2, q: int = 3, n_seg: int = 512, n_ring: int = 64,
               major: float = 1.2, tube: float = 0.35, bump: float = 0.05,
               seed: int = 1):
    """(p,q) torus-knot tube — a second Sylveon-class mesh family.

    Unlike the near-convex bumpy sphere, the knot self-shadows heavily and
    its BVH nodes overlap along the tube crossings, exercising a different
    traversal profile (deeper unions, more shadow-occlusion hits).
    Triangle count = 2 * n_seg * n_ring (defaults ≈ 65k).
    Returns (vertices [V,3] f32, indices [T,3] i32).
    """
    t = np.linspace(0.0, 2.0 * np.pi, n_seg, endpoint=False)
    r = np.cos(q * t) + 2.0
    cx = major * 0.5 * r * np.cos(p * t)
    cy = major * 0.5 * r * np.sin(p * t)
    cz = major * 0.5 * -np.sin(q * t)
    center = np.stack([cx, cy, cz], axis=1)  # [S, 3]

    # Frenet-ish frame via finite differences of the centerline.
    tangent = np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    normal = np.cross(tangent, ref)
    bad = np.linalg.norm(normal, axis=1) < 1e-6
    normal[bad] = np.cross(tangent[bad], np.array([0.0, 1.0, 0.0]))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    binorm = np.cross(tangent, normal)

    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi)
    theta = np.linspace(0.0, 2.0 * np.pi, n_ring, endpoint=False)
    # radial displacement gives the surface Sylveon-like relief
    disp = 1.0 + bump * np.sin(6.0 * theta)[None, :] * np.cos(
        8.0 * t + phase)[:, None]
    radius = tube * disp  # [S, R]
    verts = (
        center[:, None, :]
        + radius[:, :, None] * (
            np.cos(theta)[None, :, None] * normal[:, None, :]
            + np.sin(theta)[None, :, None] * binorm[:, None, :]
        )
    ).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return (i % n_seg) * n_ring + (j % n_ring)

    tris = []
    for i in range(n_seg):
        for j in range(n_ring):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            tris.append([a, b, c])
            tris.append([a, c, d])
    return verts, np.asarray(tris, np.int32)

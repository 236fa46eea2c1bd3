"""Scene assembly: OBJ / procedural geometry + lights + materials → Scene.

Counterpart of `dpt_tpu/scene/builder.py` (`load_scene`,
`cornell_box_scene`, `procedural_scene`, `knot_scene`).  Every builder
defaults to the card (`device="cuda"`) and raises when there is none; pass
`device="cpu"` for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpt_tpu_torch.scene import procedural
from dpt_tpu_torch.scene.obj import load_obj
from dpt_tpu_torch.scene.scene import (
    Lights,
    Materials,
    Scene,
    default_lights,
    f32,
    resolve_device,
)


def _scene_from_arrays(vertices, indices, uvs=None, mat_idx=None,
                       materials=None, lights=None, device="cuda") -> Scene:
    device = resolve_device(device)
    n_tri = len(indices)
    if uvs is None:
        uvs = np.zeros((n_tri, 3, 2), np.float32)
    if mat_idx is None:
        mat_idx = np.zeros((n_tri,), np.int32)
    if materials is None:
        materials = Materials.default(
            int(np.max(mat_idx)) + 1 if n_tri else 1, device=device)
    if lights is None:
        lights = default_lights(device=device)
    return Scene(
        vertices=torch.as_tensor(np.asarray(vertices, np.float32),
                                 device=device),
        indices=torch.as_tensor(np.asarray(indices, np.int32), device=device),
        uvs=torch.as_tensor(np.asarray(uvs, np.float32), device=device),
        mat_idx=torch.as_tensor(np.asarray(mat_idx, np.int32), device=device),
        materials=materials.to(device),
        lights=lights.to(device),
    )


def load_scene(path: str, lights: Lights | None = None,
               materials: Materials | None = None, device="cuda") -> Scene:
    """Load any .obj into a Scene (replaces the hard-coded path at
    VulkanRayTracer.cpp:66); without `materials`, the defaults with each
    material's Kd as its albedo."""
    device = resolve_device(device)
    mesh = load_obj(path)
    if materials is None:
        materials = dataclasses.replace(
            Materials.default(mesh.material_albedo.shape[0], device=device),
            albedo=f32(mesh.material_albedo, device))
    return _scene_from_arrays(mesh.vertices, mesh.indices, mesh.uvs,
                              mesh.mat_idx, materials, lights, device=device)


def cornell_box_scene(lights: Lights | None = None, device="cuda") -> Scene:
    """±1 cube + the reference's single area light — the box.obj setup
    (scenes/box.obj, VulkanRayTracer.cpp:149-162)."""
    v, idx = procedural.box_mesh()
    return _scene_from_arrays(v, idx, lights=lights, device=device)


def procedural_scene(n_tris_target: int = 65_000,
                     lights: Lights | None = None, device="cuda") -> Scene:
    """Sylveon-class stand-in scene (the reference asset is missing from the
    snapshot; see BASELINE.md).  The default target gives 64,008 triangles;
    bench.py's flagship target of 66,000 gives 65,024."""
    # 2 * n_lat * n_lon ≈ target with n_lon = 2 n_lat.
    n_lat = max(int(np.sqrt(n_tris_target / 4.0)), 8)
    v, idx = procedural.bumpy_sphere(n_lat=n_lat, n_lon=2 * n_lat)
    return _scene_from_arrays(v, idx, lights=lights, device=device)


def knot_scene(n_tris_target: int = 65_000,
               lights: Lights | None = None, device="cuda") -> Scene:
    """Second Sylveon-class family: a self-shadowing (2,3) torus knot."""
    # 2 * n_seg * n_ring ≈ target with n_seg = 8 n_ring.
    n_ring = max(int(np.sqrt(n_tris_target / 16.0)), 8)
    v, idx = procedural.torus_knot(n_seg=8 * n_ring, n_ring=n_ring)
    return _scene_from_arrays(v, idx, lights=lights, device=device)

"""Carry state across from the JAX package, given as numpy arrays.

No JAX counterpart: this is how a scene, camera or packed quad BVH built by
`dpt_tpu` becomes the port's, so both packages render the same thing.  The
caller converts JAX arrays with `np.asarray`; nothing here imports JAX.
Arrays are copied as they are (float32 / int32), with no renormalisation.
"""

from __future__ import annotations

import numpy as np
import torch

from dpt_tpu_torch.kernels.quad import QuadAccel
from dpt_tpu_torch.scene.camera import Camera
from dpt_tpu_torch.scene.scene import Lights, Materials, Scene, f32


def _i32(a, device):
    return torch.as_tensor(np.array(a, np.int32), device=device)


def scene_from_arrays(vertices, indices, uvs, mat_idx, albedo, roughness,
                      emission, sss_albedo, sss_radius, light_position,
                      light_normal, light_intensity, light_size,
                      device="cpu") -> Scene:
    """Scene from the arrays of a `dpt_tpu` Scene (fields in its order)."""
    return Scene(
        vertices=f32(vertices, device),
        indices=_i32(indices, device),
        uvs=f32(uvs, device),
        mat_idx=_i32(mat_idx, device),
        materials=Materials(
            albedo=f32(albedo, device),
            roughness=f32(roughness, device),
            emission=f32(emission, device),
            sss_albedo=f32(sss_albedo, device),
            sss_radius=f32(sss_radius, device),
        ),
        lights=Lights(
            position=f32(light_position, device),
            normal=f32(light_normal, device),
            intensity=f32(light_intensity, device),
            size=f32(light_size, device),
        ),
    )


def camera_from_arrays(position, direction, up, fov_deg,
                       device="cpu") -> Camera:
    """Camera from the arrays of a `dpt_tpu` Camera."""
    return Camera(
        position=f32(position, device),
        direction=f32(direction, device),
        up=f32(up, device),
        fov_deg=f32(fov_deg, device).reshape(()),
    )


def quad_accel_from_arrays(nodes_flat, tris, n_wide: int, max_depth: int,
                           device="cpu") -> QuadAccel:
    """QuadAccel from a `dpt_tpu` QuadAccel's `nodes_flat` [W*32] and
    `tris` [L, 128] (its VMEM row layout `nodes` is not needed)."""
    nodes_flat = np.asarray(nodes_flat, np.float32).reshape(-1)
    tris = np.asarray(tris, np.float32)
    if nodes_flat.size != 32 * n_wide or tris.ndim != 2 or tris.shape[1] != 128:
        raise ValueError("nodes_flat must be [n_wide*32] and tris [L, 128]")
    return QuadAccel(
        nodes_flat=f32(nodes_flat, device),
        tris=f32(tris, device),
        n_wide=int(n_wide),
        max_depth=int(max_depth),
    )

"""Carry state across from the JAX package, given as numpy arrays.

No JAX counterpart: this is how a scene, camera, packed BVH (quad or
paired-children) or parameter dict built by `dpt_tpu` becomes the port's,
so both packages render and differentiate the same thing.  The
caller converts JAX arrays with `np.asarray`; nothing here imports JAX.
Arrays are copied as they are (float32 / int32), with no renormalisation.
"""

from __future__ import annotations

import numpy as np
import torch

from dpt_tpu_torch.kernels.quad import QuadAccel
from dpt_tpu_torch.kernels.wide import WideAccel
from dpt_tpu_torch.scene.camera import Camera
from dpt_tpu_torch.scene.scene import (
    Lights,
    Materials,
    Scene,
    f32,
    resolve_device,
)


def _i32(a, device):
    return torch.as_tensor(np.array(a, np.int32), device=device)


def scene_from_arrays(vertices, indices, uvs, mat_idx, albedo, roughness,
                      emission, sss_albedo, sss_radius, light_position,
                      light_normal, light_intensity, light_size,
                      device="cuda") -> Scene:
    """Scene from the arrays of a `dpt_tpu` Scene (fields in its order)."""
    device = resolve_device(device)
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
                       device="cuda") -> Camera:
    """Camera from the arrays of a `dpt_tpu` Camera."""
    device = resolve_device(device)
    return Camera(
        position=f32(position, device),
        direction=f32(direction, device),
        up=f32(up, device),
        fov_deg=f32(fov_deg, device).reshape(()),
    )


def quad_accel_from_arrays(nodes_flat, tris, n_wide: int, max_depth: int,
                           device="cuda") -> QuadAccel:
    """QuadAccel from a `dpt_tpu` QuadAccel's `nodes_flat` [W*32] and
    `tris` [L, 128] (its VMEM row layout `nodes` is not needed)."""
    nodes_flat = np.asarray(nodes_flat, np.float32).reshape(-1)
    tris = np.asarray(tris, np.float32)
    if nodes_flat.size != 32 * n_wide or tris.ndim != 2 or tris.shape[1] != 128:
        raise ValueError("nodes_flat must be [n_wide*32] and tris [L, 128]")
    device = resolve_device(device)
    return QuadAccel(
        nodes_flat=f32(nodes_flat, device),
        tris=f32(tris, device),
        n_wide=int(n_wide),
        max_depth=int(max_depth),
    )


def wide_accel_from_arrays(nodes, tris, n_internal: int, max_depth: int,
                           device="cuda") -> WideAccel:
    """WideAccel from a `dpt_tpu` WideAccel's `nodes` [ceil(I/8), 128] and
    `tris` [L, 128]."""
    nodes = np.asarray(nodes, np.float32)
    tris = np.asarray(tris, np.float32)
    if (nodes.ndim != 2 or nodes.shape[1] != 128
            or nodes.shape[0] * 8 < n_internal or tris.ndim != 2
            or tris.shape[1] != 128):
        raise ValueError("nodes must be [ceil(n_internal/8), 128] and tris "
                         "[L, 128]")
    device = resolve_device(device)
    return WideAccel(
        nodes=f32(nodes, device),
        tris=f32(tris, device),
        n_internal=int(n_internal),
        max_depth=int(max_depth),
    )


def params_from_arrays(params: dict, device="cuda") -> dict:
    """The port's parameter dict (diff/grads.split_params) from a `dpt_tpu`
    `split_params` dict whose values are arrays; float32 copies."""
    from dpt_tpu_torch.diff.grads import PARAM_KEYS

    if set(params) != set(PARAM_KEYS):
        raise ValueError(f"parameter keys {sorted(params)} are not "
                         f"{sorted(PARAM_KEYS)}")
    device = resolve_device(device)
    return {k: f32(params[k], device) for k in PARAM_KEYS}

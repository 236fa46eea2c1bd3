"""Monte-Carlo sampling routines (vectorised, fixed draw schedule).

Counterpart of `dpt_tpu/render/sampling.py`.  Each routine reproduces the
corresponding GLSL function in raytrace_comp.comp and threads the RNG state
functionally.  Vectors are [..., 3] float32.
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.render.rng import rng_next

_PI = 3.14159265358979323846


_VEC3 = {}


def vec3(v, like):
    """Constant float32 vector on the device of tensor `like`, made once per
    value and device: a copy to the card at every call would make the host
    wait for the stream each time (a pageable host-to-device copy
    synchronises).  Never written to."""
    key = (tuple(v), like.device)
    out = _VEC3.get(key)
    if out is None:
        with torch.inference_mode(False):
            out = _VEC3[key] = torch.tensor(v, dtype=torch.float32,
                                            device=like.device)
    return out


def normalize(v):
    """v / max(|v|, 1e-20) along the last axis (safe on zero vectors)."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-20)


def random_gaussian(state):
    """Box–Muller 2-D Gaussian (raytrace_comp.comp:218-226).

    Returns (state, g) with g[..., 2].
    """
    state, u1 = rng_next(state)
    state, u2 = rng_next(state)
    u1 = torch.clamp(u1, min=1e-38)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * _PI) * u2
    return state, torch.stack([r * torch.cos(theta), r * torch.sin(theta)],
                              dim=-1)


def _orthonormal_basis(normal):
    """Tangent frame used by sampleHemisphere (raytrace_comp.comp:238-240).

    up = +Z unless |n.z| >= 0.999, then +X.
    """
    nz = normal[..., 2].abs() < 0.999
    up = torch.where(nz[..., None], vec3([0.0, 0.0, 1.0], normal),
                     vec3([1.0, 0.0, 0.0], normal))
    # Safe normalise: masked lanes may carry a zero normal.
    tangent = normalize(torch.linalg.cross(up, normal, dim=-1))
    bitangent = torch.linalg.cross(normal, tangent, dim=-1)
    return tangent, bitangent


def sample_hemisphere(normal, state):
    """Cosine-weighted hemisphere about `normal` (raytrace_comp.comp:229-243)."""
    state, r1 = rng_next(state)
    state, r2 = rng_next(state)
    theta = torch.arccos(torch.sqrt(torch.clamp(1.0 - r1, 0.0, 1.0)))
    phi = (2.0 * _PI) * r2
    st = torch.sin(theta)
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                         torch.cos(theta)], dim=-1)
    tangent, bitangent = _orthonormal_basis(normal)
    d = (
        tangent * local[..., 0:1]
        + bitangent * local[..., 1:2]
        + normal * local[..., 2:3]
    )
    return state, d


def sample_sphere(state):
    """Uniform direction on the unit sphere (raytrace_comp.comp:246-253)."""
    state, u1 = rng_next(state)
    state, u2 = rng_next(state)
    z = 2.0 * u1 - 1.0
    theta = (2.0 * _PI) * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return state, torch.stack([r * torch.cos(theta), r * torch.sin(theta), z],
                              dim=-1)


def light_basis(normal):
    """Rectangular-light tangent frame (raytrace_comp.comp:261-264).

    basis = +Y unless |n.y| >= 0.999, then +X; right = normalize(n × basis);
    up = right × n.  `normal` is assumed normalised (Light.cpp:28).
    """
    ny = normal[..., 1].abs() < 0.999
    basis = torch.where(ny[..., None], vec3([0.0, 1.0, 0.0], normal),
                        vec3([1.0, 0.0, 0.0], normal))
    right = normalize(torch.linalg.cross(normal, basis, dim=-1))
    up = torch.linalg.cross(right, normal, dim=-1)
    return right, up


def sample_area_light(light_pos, light_normal, light_size, state):
    """Uniform point on a rectangular area light (raytrace_comp.comp:255-268)."""
    state, u = rng_next(state)
    state, v = rng_next(state)
    u = u * 2.0 - 1.0
    v = v * 2.0 - 1.0
    right, up = light_basis(light_normal)
    point = (
        light_pos
        + right * (u * light_size[..., 0] * 0.5)[..., None]
        + up * (v * light_size[..., 1] * 0.5)[..., None]
    )
    return state, point


def intersect_area_light(origin, direction, light_pos, light_normal,
                         light_size):
    """Ray ∩ finite rectangle (raytrace_comp.comp:271-298).

    Returns (hit_mask, t).  `light_normal` assumed normalised.
    """
    denom = (light_normal * direction).sum(-1)
    parallel = denom.abs() < 1e-4
    safe_denom = torch.where(parallel, torch.ones_like(denom), denom)
    t = (light_normal * (light_pos - origin)).sum(-1) / safe_denom
    hit_pos = origin + direction * t[..., None]
    right, up = light_basis(light_normal)
    to_hit = hit_pos - light_pos
    u = (to_hit * right).sum(-1)
    v = (to_hit * up).sum(-1)
    inside = (u.abs() <= light_size[..., 0] * 0.5) & (
        v.abs() <= light_size[..., 1] * 0.5
    )
    hit = (~parallel) & (t > 0.0) & inside
    return hit, t


"""Shading terms beyond the reference's fixed Lambert: UV checker texture and
the Oren–Nayar rough-diffuse factor.

Counterpart of `dpt_tpu/render/shading.py`.

  - `interpolate_uv` reproduces the shader's barycentric interpolation
    (raytrace_comp.comp:151-157).
  - `checker_albedo` modulates albedo by a procedural UV checker.
  - `oren_nayar_factor` scales the NEE diffuse term by the qualitative
    Oren–Nayar model (Fujii fast form); sigma = 0 gives exactly 1.0, the
    reference's Lambert.  It is always on the main path.

The scalar twins (suffix `_s`, python floats) are copies of the JAX
package's and serve the oracle (oracle/scalar.py), in the same arithmetic
order, so both oracles agree bit for bit.
"""

from __future__ import annotations

import math

import torch


def interpolate_uv(uv_corners, u, v):
    """Barycentric UV interpolation: uv_corners [R, 3, 2]; u, v [R]."""
    w = (1.0 - u - v)[:, None]
    return (
        w * uv_corners[:, 0]
        + u[:, None] * uv_corners[:, 1]
        + v[:, None] * uv_corners[:, 2]
    )


def checker_albedo(albedo, uv, scale: float):
    """Albedo × procedural checker: cells alternate 1.0 / 0.25."""
    cell = torch.floor(uv[:, 0] * scale) + torch.floor(uv[:, 1] * scale)
    parity = torch.remainder(cell, 2.0)
    factor = torch.where(parity < 1.0, 1.0, 0.25).to(albedo.dtype)
    return albedo * factor[:, None]


def checker_albedo_s(albedo, uv, scale: float):
    cell = math.floor(uv[0] * scale) + math.floor(uv[1] * scale)
    factor = 1.0 if (cell % 2.0) < 1.0 else 0.25
    return tuple(a * factor for a in albedo)


def oren_nayar_factor(n, l, v, sigma):
    """Qualitative Oren–Nayar factor (Fujii fast form), vectorised.

    n: [R,3] shading normal; l: [R,3] light dir; v: [R,3] view dir
    (toward the camera, i.e. -ray.d); sigma: [R] roughness.
    """
    cos_i = (n * l).sum(-1)
    cos_r = (n * v).sum(-1)
    s = (l * v).sum(-1) - cos_i * cos_r
    t = torch.where(
        s > 0.0,
        torch.clamp(torch.maximum(cos_i, cos_r), min=1e-6),
        torch.ones_like(s),
    )
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    return a + b * torch.clamp(s, min=0.0) / t


def oren_nayar_factor_s(n, l, v, sigma):
    cos_i = sum(n[k] * l[k] for k in range(3))
    cos_r = sum(n[k] * v[k] for k in range(3))
    s = sum(l[k] * v[k] for k in range(3)) - cos_i * cos_r
    t = max(max(cos_i, cos_r), 1e-6) if s > 0.0 else 1.0
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    return a + b * max(s, 0.0) / t


def interpolate_uv_s(uv_corners, u, v):
    w = 1.0 - u - v
    return (
        w * uv_corners[0][0] + u * uv_corners[1][0] + v * uv_corners[2][0],
        w * uv_corners[0][1] + u * uv_corners[1][1] + v * uv_corners[2][1],
    )

"""Geometric intersection (vectorised, branch-free).

Counterpart of `dpt_tpu/render/intersect.py`: Möller–Trumbore and the
brute-force nearest / any-hit searches (raytrace_comp.comp:102-157), plus
the re-intersection of the selected triangle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dpt_tpu_torch.render.sampling import normalize

T_MAX = 1e30


def _dot(a, b):
    return (a * b).sum(-1)


def moller_trumbore(origin, direction, v0, v1, v2, eps=1e-6):
    """Ray/triangle test (raytrace_comp.comp:114-149), branch-free.

    All args broadcast; origin/direction [..., 3], v0/v1/v2 [..., 3].
    Returns (hit, t, u, v): hit is the boolean validity mask, t the ray
    parameter (garbage where ~hit), (u, v) barycentrics of v1/v2.
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    direction, edge2 = torch.broadcast_tensors(direction, edge2)
    pvec = torch.linalg.cross(direction, edge2, dim=-1)
    det = _dot(edge1, pvec)
    parallel = det.abs() < eps
    inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    tvec = origin - v0
    u = inv_det * _dot(tvec, pvec)
    tvec, edge1 = torch.broadcast_tensors(tvec, edge1)
    qvec = torch.linalg.cross(tvec, edge1, dim=-1)
    v = inv_det * _dot(direction, qvec)
    t = inv_det * _dot(edge2, qvec)
    hit = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > eps)
    )
    return hit, t, u, v


def brute_force_nearest(origin, direction, tri_v0, tri_v1, tri_v2, eps=1e-6):
    """Nearest hit by testing every triangle.

    origin/direction: [R, 3]; tri_v*: [T, 3].
    Returns (hit [R], t [R], tri_idx [R] int32, u [R], v [R]).
    Ties in t resolve to the lowest triangle index.
    """
    o = origin[:, None, :]
    d = direction[:, None, :]
    hit, t, u, v = moller_trumbore(o, d, tri_v0[None], tri_v1[None],
                                   tri_v2[None], eps)
    t_masked = torch.where(hit, t, torch.full_like(t, T_MAX))
    tri_idx = torch.argmin(t_masked, dim=1)
    best_t = t_masked.gather(1, tri_idx[:, None])[:, 0]
    any_hit = best_t < T_MAX
    u = u.gather(1, tri_idx[:, None])[:, 0]
    v = v.gather(1, tri_idx[:, None])[:, 0]
    return any_hit, best_t, tri_idx.to(torch.int32), u, v


def brute_force_occluded(origin, direction, max_dist, tri_v0, tri_v1, tri_v2,
                         eps=1e-6):
    """Any-hit query: does any triangle intersect with t < max_dist?

    Matches the shadow predicate in raytrace_comp.comp:359.
    origin/direction [R,3], max_dist [R]; returns occluded [R] bool.
    """
    o = origin[:, None, :]
    d = direction[:, None, :]
    hit, t, _, _ = moller_trumbore(o, d, tri_v0[None], tri_v1[None],
                                   tri_v2[None], eps)
    return (hit & (t < max_dist[:, None])).any(dim=1)


def rows(table, idx):
    """table[idx] along dim 0 (table [N] or [N, C], idx [R] int64), as an
    embedding lookup: many lanes share a row (every lane of one material,
    the lanes that hit one triangle), and the backward of an embedding sums
    each run of equal indices in parallel, where advanced indexing's
    backward sums a run one element after another."""
    if table.dim() == 1:
        return F.embedding(idx, table[:, None])[:, 0]
    return F.embedding(idx, table)


def reintersect(origin, direction, tri_idx, vertices, indices, eps=1e-6,
                uvs=None):
    """Re-intersect the *selected* triangle.

    The search only decides which triangle is nearest; the continuous
    quantities (t, u, v, position, geometric normal) are recomputed here.
    Normal = normalize(cross(v1-v0, v2-v0)), unflipped, matching
    raytrace_comp.comp:189.  With `uvs` ([T,3,2]) the record also carries the
    interpolated "uv" [R,2] (raytrace_comp.comp:151-157).
    """
    tri_idx = tri_idx.long()
    idx = indices[tri_idx].long()  # [R, 3]
    v0 = rows(vertices, idx[:, 0])
    v1 = rows(vertices, idx[:, 1])
    v2 = rows(vertices, idx[:, 2])
    _, t, u, v = moller_trumbore(origin, direction, v0, v1, v2, eps)
    position = origin + direction * t[:, None]
    n = normalize(torch.linalg.cross(v1 - v0, v2 - v0, dim=-1))
    rec = {"t": t, "u": u, "v": v, "position": position, "normal": n}
    if uvs is not None:
        from dpt_tpu_torch.render.shading import interpolate_uv

        rec["uv"] = interpolate_uv(uvs[tri_idx], u, v)
    return rec

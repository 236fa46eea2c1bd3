"""Nearest-hit and any-hit search dispatch: brute force or a BVH walk.

Counterpart of `dpt_tpu/render/trace.py` for the `brute`, `quad` (K1) and
`pallas` (K2) traversals.  `make_nearest(scene, cfg, accel)` returns
``nearest(origin, direction) -> {"hit", "t", "tri"}``; `make_occluded`
returns ``occluded(origin, direction, max_dist) -> [R] bool``.  The search
only decides which triangle, so every output is detached; continuous
quantities are recomputed by intersect.reintersect.  With cfg.ray_sort the
BVH queries are wrapped in the coherence sort (render/compaction.py), as in
the JAX package; the brute path is never sorted.
"""

from __future__ import annotations

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.intersect import (
    brute_force_nearest,
    brute_force_occluded,
)


def _scene_bounds(scene):
    v = scene.vertices.detach()
    return v.min(dim=0).values, v.max(dim=0).values


def _walks(cfg, accel):
    """(nearest, occluded) of the BVH walk cfg.traversal selects."""
    if cfg.traversal not in ("quad", "pallas"):
        # RenderConfig already rejects the known traversals not ported yet.
        raise ValueError(f"unknown traversal mode: {cfg.traversal}")
    if accel is None:
        raise ValueError(f"traversal={cfg.traversal!r} requires an accel "
                         "(accel.bvh.build_accel)")
    if cfg.traversal == "quad":
        from dpt_tpu_torch.kernels.quad import quad_nearest, quad_occluded

        return quad_nearest, quad_occluded
    from dpt_tpu_torch.kernels.wide import wide_nearest, wide_occluded

    return wide_nearest, wide_occluded


def _detached_corners(scene):
    return tuple(v.detach() for v in scene.tri_vertices())


def make_nearest(scene, cfg: RenderConfig, accel=None):
    if cfg.traversal == "brute":
        v0, v1, v2 = _detached_corners(scene)

        def nearest(o, d):
            hit, t, tri, _, _ = brute_force_nearest(o.detach(), d.detach(),
                                                    v0, v1, v2, cfg.eps)
            return {"hit": hit, "t": t, "tri": tri}

        return nearest

    walk, _ = _walks(cfg, accel)

    def nearest(o, d):
        hit, t, tri = walk(o.detach(), d.detach(), accel, cfg)
        return {"hit": hit, "t": t, "tri": tri}

    if not cfg.ray_sort:
        return nearest
    from dpt_tpu_torch.render.compaction import sorted_nearest

    return sorted_nearest(nearest, *_scene_bounds(scene))


def make_occluded(scene, cfg: RenderConfig, accel=None):
    """Any-hit shadow query: same predicate as nearest + `t < max_dist`
    (raytrace_comp.comp:359), terminating at the first hit."""
    if cfg.traversal == "brute":
        v0, v1, v2 = _detached_corners(scene)

        def occluded(o, d, max_dist):
            return brute_force_occluded(o.detach(), d.detach(),
                                        max_dist.detach(), v0, v1, v2,
                                        cfg.eps)

        return occluded

    _, walk = _walks(cfg, accel)

    def occluded(o, d, max_dist):
        return walk(o.detach(), d.detach(), max_dist.detach(), accel, cfg)

    if not cfg.ray_sort:
        return occluded
    from dpt_tpu_torch.render.compaction import sorted_occluded

    return sorted_occluded(occluded, *_scene_bounds(scene))

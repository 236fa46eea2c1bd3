"""Nearest-hit and any-hit search dispatch: brute force or the quad walk.

Counterpart of `dpt_tpu/render/trace.py` for the `brute` and `quad`
traversals.  `make_nearest(scene, cfg, accel)` returns
``nearest(origin, direction) -> {"hit", "t", "tri"}``; `make_occluded`
returns ``occluded(origin, direction, max_dist) -> [R] bool``.  The search
only decides which triangle; continuous quantities are recomputed by
intersect.reintersect.  With cfg.ray_sort the quad queries are wrapped in
the coherence sort (render/compaction.py), as in the JAX package; the brute
path is never sorted.
"""

from __future__ import annotations

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.intersect import (
    brute_force_nearest,
    brute_force_occluded,
)


def _scene_bounds(scene):
    v = scene.vertices
    return v.min(dim=0).values, v.max(dim=0).values


def _check(cfg, accel):
    # RenderConfig already rejects the known traversals that are not ported.
    if cfg.traversal not in ("brute", "quad"):
        raise ValueError(f"unknown traversal mode: {cfg.traversal}")
    if cfg.traversal == "quad" and accel is None:
        raise ValueError("traversal='quad' requires a QuadAccel")


def make_nearest(scene, cfg: RenderConfig, accel=None):
    _check(cfg, accel)
    if cfg.traversal == "brute":
        v0, v1, v2 = scene.tri_vertices()

        def nearest(o, d):
            hit, t, tri, _, _ = brute_force_nearest(o, d, v0, v1, v2,
                                                    cfg.eps)
            return {"hit": hit, "t": t, "tri": tri}

        return nearest

    from dpt_tpu_torch.kernels.quad import quad_nearest

    def nearest(o, d):
        hit, t, tri = quad_nearest(o, d, accel, cfg)
        return {"hit": hit, "t": t, "tri": tri}

    if not cfg.ray_sort:
        return nearest
    from dpt_tpu_torch.render.compaction import sorted_nearest

    return sorted_nearest(nearest, *_scene_bounds(scene))


def make_occluded(scene, cfg: RenderConfig, accel=None):
    """Any-hit shadow query: same predicate as nearest + `t < max_dist`
    (raytrace_comp.comp:359), terminating at the first hit."""
    _check(cfg, accel)
    if cfg.traversal == "brute":
        v0, v1, v2 = scene.tri_vertices()

        def occluded(o, d, max_dist):
            return brute_force_occluded(o, d, max_dist, v0, v1, v2, cfg.eps)

        return occluded

    from dpt_tpu_torch.kernels.quad import quad_occluded

    def occluded(o, d, max_dist):
        return quad_occluded(o, d, max_dist, accel, cfg)

    if not cfg.ray_sort:
        return occluded
    from dpt_tpu_torch.render.compaction import sorted_occluded

    return sorted_occluded(occluded, *_scene_bounds(scene))


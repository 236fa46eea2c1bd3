"""Per-ray stack walk of the binary BVH in torch ops: the `bvh`, `packet`
and `threaded` traversals.

Counterpart of `dpt_tpu/accel/traverse.py` (`bvh_nearest` /
`bvh_occluded`), and the port of `dpt_tpu/accel/packet.py` and
`dpt_tpu/accel/threaded.py` as well.  Those two are TPU execution
strategies for the same nearest / any-hit function: `packet` walks one
stack per tile of rays (a subtree is entered when any ray of the tile hits
its box), and `threaded` flattens the tree into per-octant skip-pointer
tables so that every ray walks without a stack and without scatters, which
a vector machine needs and a GPU does not.  Both return the nearest hit
(or the any-hit) of every ray, as this walk does.  So the port maps them
onto this one walk, over the tree each mode builds
(`accel/bvh.py:build_accel`: `packet` the same tree as `bvh`, the LBVH
unpruned; `threaded` the LBVH pruned), instead of porting three walks.
`hit` and `occluded` are the same as the JAX package's for each mode; `t`
is allclose and `tri` differs only between triangles hit at an equal t,
where the visit order decides.

The walk, as in the JAX package: every ray keeps its own stack in an
[R, S] table (S = cfg.bvh_stack_depth), pops a node, tests its box (kept
when t_near <= best t, or < max_dist for the any-hit query), tests a
leaf's triangles in slot order (a hit replaces the best only at a smaller
t), and pushes an internal node's right child, then its left, so the left
child is visited first.  An any-hit ray stops at its first hit below
max_dist.  The JAX walk advances every ray in lockstep until the slowest
is done; here each step runs on the rays still walking only (one host
sync a step).  This is the plain reference path: no CUDA kernel serves
these modes, on either device.
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.kernels.quad import _safe_inv
from dpt_tpu_torch.render.intersect import T_MAX, moller_trumbore


def _slab(origin, inv_dir, box_min, box_max):
    """Slab test (raytrace_comp.comp:102-112): (hit, t_min)."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    t_min = torch.minimum(t0, t1).max(dim=-1).values
    t_max = torch.maximum(t0, t1).min(dim=-1).values
    return (t_min <= t_max) & (t_max >= 0.0), t_min


def _walk(origin, direction, max_dist, bvh, v0, v1, v2, cfg):
    """(best_t [R] f32, best_tri [R] int64) for max_dist None (nearest),
    else (occluded [R] bool, None)."""
    occluded = max_dist is not None
    dev = origin.device
    R = origin.shape[0]
    S = cfg.bvh_stack_depth
    node_min, node_max = bvh.node_min, bvh.node_max
    left = bvh.node_left.long()
    right = bvh.node_right.long()
    order = bvh.tri_order.long()
    n_slots = order.shape[0]
    leaf_max = int((-left).clamp(min=0).max())
    inv_all = _safe_inv(direction)

    best_t = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    best_tri = torch.zeros((R,), dtype=torch.int64, device=dev)
    occ = torch.zeros((R,), dtype=torch.bool, device=dev)
    stack = torch.zeros((R, S), dtype=torch.int64, device=dev)  # root 0
    sp = torch.ones((R,), dtype=torch.int64, device=dev)
    ids = torch.arange(R, device=dev)  # the rays still walking
    while ids.numel():
        o, d, inv = origin[ids], direction[ids], inv_all[ids]
        s = sp[ids] - 1
        node = stack[ids, s]
        box_hit, t_min = _slab(o, inv, node_min[node], node_max[node])
        if occluded:
            md = max_dist[ids]
            box_hit = box_hit & (t_min < md)
            hit_any = occ[ids]
        else:
            bt, bi = best_t[ids], best_tri[ids]
            box_hit = box_hit & (t_min <= bt)
        lft, rgt = left[node], right[node]
        is_leaf = lft < 0
        for k in range(leaf_max):
            valid = box_hit & is_leaf & (k < -lft)
            tri = order[(rgt + k).clamp(0, n_slots - 1)]
            hit_k, t_k, _, _ = moller_trumbore(o, d, v0[tri], v1[tri],
                                               v2[tri], cfg.eps)
            if occluded:
                hit_any = hit_any | (valid & hit_k & (t_k < md))
            else:
                upd = valid & hit_k & (t_k < bt)
                bt = torch.where(upd, t_k, bt)
                bi = torch.where(upd, tri, bi)
        # Push right, then left (popped first).  A ray that pushes nothing
        # writes above its top, where nothing is read.
        push = (box_hit & ~is_leaf).long()
        stack[ids, s.clamp(max=S - 1)] = rgt
        stack[ids, (s + push).clamp(max=S - 1)] = lft
        s = s + 2 * push
        if occluded:
            occ[ids] = hit_any
            s = torch.where(hit_any, torch.zeros_like(s), s)
        else:
            best_t[ids], best_tri[ids] = bt, bi
        sp[ids] = s
        ids = ids[s > 0]
    if occluded:
        return occ, None
    return best_t, best_tri


def bvh_nearest(origin, direction, bvh, v0, v1, v2, cfg):
    """Nearest hit: (hit [R] bool, t [R] f32, tri [R] int32 (0 on a
    miss)).  bvh: an accel.bvh.BVH of tensors on the rays' device; v0 /
    v1 / v2: the triangles' corners [T, 3]."""
    t, tri = _walk(origin, direction, None, bvh, v0, v1, v2, cfg)
    hit = t < T_MAX
    return hit, t, torch.where(hit, tri, torch.zeros_like(tri)).to(
        torch.int32)


def bvh_occluded(origin, direction, max_dist, bvh, v0, v1, v2, cfg):
    """Any hit with t < max_dist: occluded [R] bool."""
    return _walk(origin, direction, max_dist, bvh, v0, v1, v2, cfg)[0]

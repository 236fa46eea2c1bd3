"""Four-wide BVH: host packing and the nearest / any-hit walk (kernel K1).

Counterpart of `dpt_tpu/kernels/pallas_quad.py`.

  - `pack_quad` is a copy of the JAX package's vectorised packer: it
    collapses two binary levels into one 32-lane record (4 child AABBs in
    lanes 0-23, child pointers in lanes 24-27 — >= 0 a record id, < 0 the
    leaf row -(row+1) — and per-octant "left is nearer" masks in lanes
    28-30), plus row-aligned leaves (1 row = up to 8 triangles x 16 lanes
    (v0, e1, e2, oid, valid)).  Empty slots carry NaN boxes, which fail
    every comparison.  The TPU-only row layout and memory-mode budgets are
    not carried over: on the card both tables stay in global memory.
  - `refit_quad` refits the packed tables to moved vertices with torch
    gathers and min / max, for vertex optimisation.
  - `quad_nearest` / `quad_occluded` launch the hand-written CUDA kernel
    (csrc/quad_traverse.cu: one ray per group of four lanes for a stream
    of at most GROUP_MAX_RAYS rays, else one ray per lane) for CUDA tensors
    and run the plain PyTorch walk (`quad_nearest_reference` /
    `quad_occluded_reference`) for CPU tensors.
    There is no fallback between the two: a CUDA tensor launches the kernel
    or raises.

Both walks compute what the TPU kernel computes, one ray at a time instead
of the TPU's tile-union walk: the ray's own direction octant picks the near
child (the TPU kernel votes per tile), the leaf children of a record are
intersected in slot order before any push, and internal children are pushed
far to near.  The plain walk spells out the slab and Möller–Trumbore
arithmetic as separate elementwise ops in the kernel's order, and the
kernel is built with `-fmad=false`, so on the card the two agree exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpt_tpu_torch.scene.scene import resolve_device, to_device

T_MAX = 1e30
# Per-ray stack capacity of the CUDA kernel (kStack in quad_traverse.cu).
KERNEL_STACK = 64
# Möller–Trumbore epsilon hard-coded by the TPU kernel (pallas_quad.py:610,
# :627) for both the parallel test and t > eps; cfg.eps is not used here.
_EPS = 1e-6
_TINY = 1e-20
# The largest stream the kernel walks with one ray per group of four lanes;
# a larger one takes one ray per lane.  Timed on an H100 (132 SMs) over
# the flagship's tables (scripts/torch_walk_ablation.py): groups are ahead
# on every stream of up to 2**18 rays in both modes, incoherent and
# primary, and behind on incoherent streams from 3 * 2**17 rays on.
GROUP_MAX_RAYS = 1 << 18
# The kernel's C export of each design (kernels/build.py WALKS).
_EXPORTS = {"lane": "quad_traverse", "group": "quad_traverse_group"}

# Kernel launches per mode, and the same launches per design.  Each wrapper
# adds one where it launches the CUDA kernel and nowhere else; the plain
# walk does not count.
launch_counts = {"nearest": 0, "occluded": 0}
design_counts = {"lane": 0, "group": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, design_counts):
        for k in counts:
            counts[k] = 0


@dataclasses.dataclass
class QuadAccel:
    """4-wide BVH + row-aligned leaves, packed for the quad walk."""

    nodes_flat: torch.Tensor  # [W*32] f32 — record-major
    tris: torch.Tensor  # [n_leaf_rows, 128] f32 — 1 leaf/row, 8 tris x 16
    n_wide: int
    # Depth of the QUAD tree.  Each pop pushes at most 3 extra entries, so
    # the stack never holds more than 3*max_depth + 1 entries.
    max_depth: int = 0

    def to(self, device) -> "QuadAccel":
        return to_device(self, device)


# Empty slots must never pass the slab test: NaN bounds make every
# comparison False, on any ray.
_EMPTY_BOX = np.full(6, np.nan, np.float32)

# Sign vector of each direction octant, for the vectorised near-mask.
_OCT_SIGNS = np.array(
    [[1.0 if o & 4 else -1.0,
      1.0 if o & 2 else -1.0,
      1.0 if o & 1 else -1.0] for o in range(8)],
    np.float32,
)  # [8, 3]
_OCT_BITS = (1 << np.arange(8)).astype(np.float32)  # [8]


def _octant_near_masks(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """8-bit masks over center pairs [k, 3] -> [k]: bit o = 1 when `ca` is
    nearer than `cb` along direction-octant o."""
    da = ca @ _OCT_SIGNS.T  # [k, 8]
    db = cb @ _OCT_SIGNS.T
    return ((da <= db).astype(np.float32) * _OCT_BITS).sum(axis=1)


def pack_quad(bvh, v0, v1, v2, device="cuda") -> QuadAccel:
    """Collapse a binary accel.bvh.BVH into the 4-wide layout.

    A copy of `dpt_tpu.kernels.pallas_quad.pack_quad` (record ids in level
    order, every level packed with numpy array ops); returns tensors on
    `device`.
    """
    device = resolve_device(device)
    nmin = np.asarray(bvh.node_min, np.float32)
    nmax = np.asarray(bvh.node_max, np.float32)
    left = np.asarray(bvh.node_left, np.int64)
    right = np.asarray(bvh.node_right, np.int64)
    order = np.asarray(bvh.tri_order, np.int64)
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)

    is_leaf = left < 0
    counts = np.where(is_leaf, -left, 0)
    if is_leaf.any() and counts[is_leaf].max() > 8:
        raise ValueError("the quad layout requires bvh_leaf_size <= 8")
    center = 0.5 * (nmin + nmax)

    # --- leaf rows (flat scatter) ---
    leaf_rows = np.cumsum(is_leaf) - 1  # valid where is_leaf
    leaf_ids = np.nonzero(is_leaf)[0]
    L = max(int(leaf_ids.size), 1)
    tris = np.zeros((L, 128), np.float32)
    if leaf_ids.size:
        c = counts[leaf_ids]
        first = right[leaf_ids]
        rows_rep = np.repeat(np.arange(leaf_ids.size), c)
        slot = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
        tids = order[np.repeat(first, c) + slot]
        trows = tris.reshape(-1, 8, 16)
        trows[rows_rep, slot, 0:3] = v0[tids]
        trows[rows_rep, slot, 3:6] = v1[tids] - v0[tids]
        trows[rows_rep, slot, 6:9] = v2[tids] - v0[tids]
        trows[rows_rep, slot, 9] = tids.astype(np.float32)
        trows[rows_rep, slot, 10] = 1.0

    def result(rec_arr, n_wide, max_depth):
        return QuadAccel(
            nodes_flat=torch.as_tensor(rec_arr.reshape(-1), device=device),
            tris=torch.as_tensor(tris, device=device),
            n_wide=n_wide,
            max_depth=max_depth,
        )

    if is_leaf[0]:
        # Degenerate single-leaf tree: one record, slot 0 = the leaf.
        rec = np.zeros((1, 32), np.float32)
        for s in range(4):
            rec[0, 6 * s:6 * s + 6] = _EMPTY_BOX
        rec[0, 28:31] = 255.0
        rec[0, 0:3] = nmin[0]
        rec[0, 3:6] = nmax[0]
        rec[0, 24] = float(-(leaf_rows[0] + 1))
        return result(rec, 1, 1)

    # --- level-order collapse: anchors of level k+1 are the internal
    # grandchildren (or internal leaf-adjacent children's children) of
    # level k's anchors, in row-major (anchor, slot) order.
    level_blocks = []  # per-level [F, 32] record blocks
    level_children = []  # per-level [F, 4] quad child record ids (-1: none)
    frontier = np.array([0], np.int64)
    n_assigned = 1  # record ids handed out so far (root = 0)

    while frontier.size:
        F = frontier.size
        rec = np.zeros((F, 32), np.float32)
        for s in range(4):
            rec[:, 6 * s:6 * s + 6] = _EMPTY_BOX
        rec[:, 28:31] = 255.0

        l, r = left[frontier], right[frontier]
        rec[:, 28] = _octant_near_masks(center[l], center[r])

        # slot_node[f, s]: binary node occupying slot s (-1 = empty).
        slot_node = np.full((F, 4), -1, np.int64)
        for child, s0, mask_lane in ((l, 0, 29), (r, 2, 30)):
            child_leaf = is_leaf[child]
            # Leaf child -> occupies slot s0 alone.
            slot_node[:, s0] = np.where(child_leaf, child, slot_node[:, s0])
            # Internal child -> its two children fill the pair; mask lane
            # records their near-order.
            ci = np.nonzero(~child_leaf)[0]
            if ci.size:
                cl, cr = left[child[ci]], right[child[ci]]
                slot_node[ci, s0] = cl
                slot_node[ci, s0 + 1] = cr
                rec[ci, mask_lane] = _octant_near_masks(center[cl], center[cr])

        valid = slot_node >= 0
        sn = np.where(valid, slot_node, 0)
        for s in range(4):
            v_s = valid[:, s]
            rec[v_s, 6 * s:6 * s + 3] = nmin[sn[v_s, s]]
            rec[v_s, 6 * s + 3:6 * s + 6] = nmax[sn[v_s, s]]

        # Pointers: leaf slot -> -(leaf_row+1); internal slot -> the next
        # level's record id, assigned in row-major (anchor, slot) order.
        slot_leaf = valid & is_leaf[sn]
        slot_int = valid & ~is_leaf[sn]
        ptr = np.zeros((F, 4), np.float32)
        ptr[slot_leaf] = -(leaf_rows[sn[slot_leaf]] + 1)
        n_new = int(slot_int.sum())
        new_ids = n_assigned + np.arange(n_new)
        ptr[slot_int] = new_ids
        rec[:, 24:28] = ptr

        child_ids = np.full((F, 4), -1, np.int64)
        child_ids[slot_int] = new_ids
        level_blocks.append(rec)
        level_children.append(child_ids)
        frontier = sn[slot_int]
        n_assigned += n_new

    rec_arr = np.concatenate(level_blocks, axis=0)
    W = rec_arr.shape[0]

    # Quad-tree depth: bottom-up over levels (children always live one
    # level deeper, so each level's depth needs only the next level's).
    depth = np.zeros(W, np.int64)
    lo = W
    for rec_blk, child_ids in zip(reversed(level_blocks),
                                  reversed(level_children)):
        lo -= rec_blk.shape[0]
        cd = np.where(child_ids >= 0, depth[np.maximum(child_ids, 0)], 0)
        depth[lo:lo + rec_blk.shape[0]] = 1 + cd.max(axis=1) * (
            child_ids >= 0
        ).any(axis=1)

    return result(rec_arr, W, int(depth[0]))


def refit_quad(accel: QuadAccel, vertices, indices) -> QuadAccel:
    """Refit the quad accel to moved vertices (pallas_quad.py:270-352).

    Topology, pointers, leaf assignment and near masks stay as packed; the
    leaf rows are regathered from `vertices` and every slot AABB is
    recomputed bottom-up with `max_depth` sweeps of a gather plus min/max.
    Leaf boxes are taken over the raw corners (not v0 + e1), and empty slots
    keep their NaN boxes, so refitting with unchanged vertices gives the
    packed tables bit for bit.  Runs on the accel's device with torch ops.
    """
    vertices = vertices.detach()
    W = accel.n_wide
    inf = torch.tensor(float("inf"), device=vertices.device)
    nan = torch.tensor(float("nan"), device=vertices.device)

    trows = accel.tris.reshape(-1, 8, 16)
    tids = trows[:, :, 9].to(torch.int64)
    vm = (trows[:, :, 10] > 0.0)[..., None]
    idx = indices.long()[tids.clamp(min=0)]  # [L, 8, 3]
    v0, v1, v2 = (vertices[idx[..., k]] for k in range(3))
    zero = torch.zeros_like(v0)
    new_rows = trows.clone()
    new_rows[:, :, 0:3] = torch.where(vm, v0, zero)
    new_rows[:, :, 3:6] = torch.where(vm, v1 - v0, zero)
    new_rows[:, :, 6:9] = torch.where(vm, v2 - v0, zero)

    corners = torch.stack([v0, v1, v2], dim=2)  # [L, 8, 3, 3]
    cmask = vm[:, :, None, :]
    leaf_min = torch.where(cmask, corners, inf).amin(dim=(1, 2))  # [L, 3]
    leaf_max = torch.where(cmask, corners, -inf).amax(dim=(1, 2))

    rec = accel.nodes_flat.reshape(W, 32)
    ptr = rec[:, 24:28]
    empty = torch.isnan(rec[:, 0:24:6])  # [W, 4]: NaN-boxed at pack time
    leaf_slot = (~empty) & (ptr < 0.0)
    leaf_row = (-ptr - 1.0).to(torch.int64).clamp(min=0)
    child_id = ptr.clamp(min=0.0).to(torch.int64)
    lmin, lmax = leaf_min[leaf_row], leaf_max[leaf_row]  # [W, 4, 3]
    ls, em = leaf_slot[..., None], empty[..., None]
    smin = torch.where(ls, lmin, inf)
    smax = torch.where(ls, lmax, -inf)
    for _ in range(max(accel.max_depth, 1)):
        rmin = torch.where(em, inf, smin).amin(dim=1)  # [W, 3]
        rmax = torch.where(em, -inf, smax).amax(dim=1)
        smin = torch.where(ls, lmin, torch.where(em, nan, rmin[child_id]))
        smax = torch.where(ls, lmax, torch.where(em, nan, rmax[child_id]))

    new_rec = rec.clone()
    for s in range(4):
        new_rec[:, 6 * s:6 * s + 3] = smin[:, s]
        new_rec[:, 6 * s + 3:6 * s + 6] = smax[:, s]
    return dataclasses.replace(accel, nodes_flat=new_rec.reshape(-1),
                               tris=new_rows.reshape(accel.tris.shape))


def check_stack(accel: QuadAccel, cfg) -> None:
    """Stack guard (pallas_quad.py:875-882), also bounded by the kernel's
    fixed per-thread capacity."""
    need = 3 * accel.max_depth + 2
    if need > cfg.bvh_stack_depth or need > KERNEL_STACK:
        raise ValueError(
            f"quad BVH depth {accel.max_depth} needs stack_depth >= {need}, "
            f"got {cfg.bvh_stack_depth} (kernel capacity {KERNEL_STACK})"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch walk: per-ray stack, vectorised over the live rays.
# ---------------------------------------------------------------------------


def _safe_inv(v):
    tiny = torch.full_like(v, _TINY)
    w = torch.where(v.abs() < _TINY, torch.where(v >= 0.0, tiny, -tiny), v)
    return torch.reciprocal(w)


def _slab(rec, b, ray):
    """Slab test of the box at lanes b..b+5 of `rec` [n, 32], in the order
    of pallas_quad.py:560-574 (torch.minimum/maximum propagate NaN, as the
    kernel's min/max do)."""
    ox, oy, oz, ix, iy, iz = ray
    t0 = (rec[:, b + 0] - ox) * ix
    t1 = (rec[:, b + 3] - ox) * ix
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t0 = (rec[:, b + 1] - oy) * iy
    t1 = (rec[:, b + 4] - oy) * iy
    tn = torch.maximum(tn, torch.minimum(t0, t1))
    tf = torch.minimum(tf, torch.maximum(t0, t1))
    t0 = (rec[:, b + 2] - oz) * iz
    t1 = (rec[:, b + 5] - oz) * iz
    tn = torch.maximum(tn, torch.minimum(t0, t1))
    tf = torch.minimum(tf, torch.maximum(t0, t1))
    return tn, tf


def _leaf_tests(o, d, trow, eps=_EPS):
    """Möller–Trumbore of rays o, d ([k, 3]) against the slots of their
    leaf rows trow [k, 8, 16] (or one table [1, S, 16] for every ray), in
    the order of pallas_quad.py:606-629, with `eps` in the parallel test
    and in t > eps.  Returns (hit, t, oid int32), each [k, 8] (or [k, S])."""
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z = trow[..., 0], trow[..., 1], trow[..., 2]
    e1x, e1y, e1z = trow[..., 3], trow[..., 4], trow[..., 5]
    e2x, e2y, e2z = trow[..., 6], trow[..., 7], trow[..., 8]
    oid = trow[..., 9].to(torch.int32)
    valid = trow[..., 10] > 0.5

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    parallel = det.abs() < eps
    inv_det = torch.reciprocal(torch.where(parallel, torch.ones_like(det), det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = inv_det * (tx * px + ty * py + tz * pz)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = inv_det * (dx * qx + dy * qy + dz * qz)
    t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    hit = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > eps)
        & valid
    )
    return hit, t, oid


def _walk_reference(origin, direction, max_dist, accel: QuadAccel,
                    occluded: bool, stack_depth: int, stats=None):
    """Per-ray ordered stack walk over `accel`, vectorised over the rays
    still walking.  Returns (t [R] f32, tri [R] int32) for nearest mode and
    (unused, occ [R] int32) for occluded mode, as the kernel does.  With a
    `stats` dict, adds the records visited and triangles tested to its
    "node_visits" and "tri_tests", and sets its "ray_visits" to the records
    each ray visited ([R] int64; 0 for a masked lane)."""
    R = origin.shape[0]
    dev = origin.device
    out_t = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    out_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    nodes = accel.nodes_flat.view(-1, 32)
    trows = accel.tris.view(-1, 8, 16)

    o = origin
    d = direction
    md = max_dist
    ids = torch.arange(R, device=dev)
    if occluded:
        # Masked lanes (max_dist <= 0) are resolved at once: not occluded.
        keep = ~(md <= 0.0)
        ids, o, d, md = ids[keep], o[keep], d[keep], md[keep]
    n = ids.numel()
    inv = _safe_inv(d)
    octant = ((d[:, 0] >= 0.0).long() * 4 + (d[:, 1] >= 0.0).long() * 2
              + (d[:, 2] >= 0.0).long())
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    visits = tests = 0
    ray_visits = (torch.zeros((R,), dtype=torch.int64, device=dev)
                  if stats is not None else None)

    while n:
        visits += n
        if ray_visits is not None:
            ray_visits[ids] += 1
        rows = torch.arange(n, device=dev)
        ray = (o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2])
        sp = sp - 1
        rec = nodes[stack[rows, sp]]  # [n, 32]

        hits, ptrs = [], []
        for s in range(4):
            tn, tf = _slab(rec, 6 * s, ray)
            if occluded:
                h = (tn <= tf) & (tf >= 0.0) & (tn < md)
            else:
                h = (tn <= tf) & (tf >= 0.0) & (tn <= best_t)
            hits.append(h)
            ptrs.append(rec[:, 24 + s])

        # Leaf children resolve in slot order, before any push.
        for s in range(4):
            sel = torch.nonzero(hits[s] & (ptrs[s] < 0.0)).squeeze(1)
            if sel.numel() == 0:
                continue
            tests += 8 * sel.numel()
            row = (-ptrs[s][sel] - 1.0).to(torch.int64)
            th, tt, toid = _leaf_tests(o[sel], d[sel], trows[row])
            if occluded:
                newly = (th & (tt < md[sel][:, None])).any(dim=1)
                occ[sel] = occ[sel] | newly
            else:
                # Strict t < best_t updates in slot order == the first
                # minimum over the hit slots, if below best_t.
                tm = torch.where(th, tt, torch.full_like(tt, float("inf")))
                m, k = torch.min(tm, dim=1)
                upd = m < best_t[sel]
                best_t[sel] = torch.where(upd, m, best_t[sel])
                best_i[sel] = torch.where(
                    upd, toid.gather(1, k[:, None])[:, 0], best_i[sel])

        # Internal children are pushed far to near, so the near one pops
        # first (pallas_quad.py:687-726).
        push = torch.stack([hits[s] & (ptrs[s] >= 0.0) for s in range(4)], 1)
        ptr = torch.stack(ptrs, 1)
        if occluded:
            ranks = [torch.full_like(sp, k) for k in range(4)]
        else:
            def near_bit(lane):
                return ((rec[:, lane].to(torch.int64) >> octant) & 1) == 1

            near_a, near_b, near_c = near_bit(28), near_bit(29), near_bit(30)
            l_near = torch.where(near_b, 0, 1)
            r_near = torch.where(near_c, 2, 3)
            l_far = 1 - l_near
            r_far = 5 - r_near
            ranks = [
                torch.where(near_a, l_near, r_near),
                torch.where(near_a, l_far, r_far),
                torch.where(near_a, r_near, l_near),
                torch.where(near_a, r_far, l_far),
            ]
        for k in (3, 2, 1, 0):
            idx = ranks[k][:, None]
            do = push.gather(1, idx)[:, 0]
            pt = ptr.gather(1, idx)[:, 0].to(torch.int64)
            stack[rows[do], sp[do]] = pt[do]
            sp = sp + do.long()

        done = sp == 0
        if occluded:
            done = done | occ
            out_i[ids[occ]] = 1
        else:
            out_t[ids[done]] = best_t[done]
            out_i[ids[done]] = best_i[done]
        keep = ~done
        ids, o, d, md, inv, octant = (
            x[keep] for x in (ids, o, d, md, inv, octant))
        stack, sp, best_t, best_i, occ = (
            x[keep] for x in (stack, sp, best_t, best_i, occ))
        n = ids.numel()
    if stats is not None:
        stats["node_visits"] = stats.get("node_visits", 0) + visits
        stats["tri_tests"] = stats.get("tri_tests", 0) + tests
        stats["ray_visits"] = ray_visits
    return out_t, out_i


def quad_nearest_reference(origin, direction, accel: QuadAccel, cfg,
                           stats=None):
    """Plain PyTorch nearest hit: (hit, t, tri)."""
    check_stack(accel, cfg)
    md = torch.zeros((origin.shape[0],), dtype=torch.float32,
                     device=origin.device)
    t, tri = _walk_reference(origin, direction, md, accel, False,
                             cfg.bvh_stack_depth, stats)
    hit = t < T_MAX
    return hit, t, torch.where(hit, tri, torch.zeros_like(tri))


def quad_occluded_reference(origin, direction, max_dist, accel: QuadAccel,
                            cfg, stats=None):
    """Plain PyTorch any-hit query: occluded [R] bool."""
    check_stack(accel, cfg)
    _, occ = _walk_reference(origin, direction, max_dist, accel, True,
                             cfg.bvh_stack_depth, stats)
    return occ.bool()


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.
# ---------------------------------------------------------------------------


def _check_inputs(origin, direction, max_dist, accel: QuadAccel):
    from dpt_tpu_torch.kernels.build import check_rays

    check_rays(origin, direction, max_dist)
    dev = origin.device
    for name, x in (("nodes_flat", accel.nodes_flat), ("tris", accel.tris)):
        if x.dtype != torch.float32:
            raise TypeError(f"accel.{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"accel.{name} is on {x.device}, rays on {dev}")
    if accel.nodes_flat.numel() != 32 * accel.n_wide:
        raise ValueError("accel.nodes_flat must hold 32 * n_wide floats")
    if accel.tris.dim() != 2 or accel.tris.shape[1] != 128:
        raise ValueError("accel.tris must have shape [L, 128]")


def walk_design(n_rays: int) -> str:
    """The design K1 walks a stream of `n_rays` in: "group" (one ray per
    group of four lanes) up to GROUP_MAX_RAYS rays, else "lane"."""
    return "group" if n_rays <= GROUP_MAX_RAYS else "lane"


def _launch(origin, direction, max_dist, accel: QuadAccel, occluded: bool,
            design=None):
    """Launch K1 on the current stream: (t [R] f32 or None, tri/occ [R]
    int32), in walk_design's pick unless `design` ("lane" or "group")
    forces one."""
    from dpt_tpu_torch.kernels.build import launch_walk

    R = origin.shape[0]
    design = design or walk_design(R)
    out = launch_walk(_EXPORTS[design], origin, direction, max_dist,
                      accel.nodes_flat, accel.tris, occluded)
    if R:
        launch_counts["occluded" if occluded else "nearest"] += 1
        design_counts[design] += 1
    return out


def _dispatch(origin, direction, max_dist, accel, cfg, occluded: bool):
    """(t, tri) in nearest mode, (t or None, occluded) in occluded mode.  In
    nearest mode `max_dist` is None: the kernel never reads one, and the
    plain walk gets zeros."""
    check_stack(accel, cfg)
    _check_inputs(origin, direction, max_dist, accel)
    if origin.is_cuda:
        return _launch(origin, direction, max_dist, accel, occluded)
    if origin.device.type != "cpu":
        raise ValueError(f"quad walk: unsupported device {origin.device}")
    if max_dist is None:
        max_dist = torch.zeros((origin.shape[0],), dtype=torch.float32,
                               device=origin.device)
    return _walk_reference(origin, direction, max_dist, accel, occluded,
                           cfg.bvh_stack_depth)


def quad_nearest(origin, direction, accel: QuadAccel, cfg):
    """Nearest hit via the 4-wide walk: (hit [R] bool, t [R] f32, tri [R]
    int32, 0 on a miss).  CUDA tensors launch the kernel; CPU tensors take
    the plain walk."""
    t, tri = _dispatch(origin, direction, None, accel, cfg, False)
    return t < T_MAX, t, tri


def quad_occluded(origin, direction, max_dist, accel: QuadAccel, cfg):
    """Any-hit query via the 4-wide walk: occluded [R] bool (a hit with
    t < max_dist; lanes with max_dist <= 0 are never occluded)."""
    _, occ = _dispatch(origin, direction, max_dist, accel, cfg, True)
    return occ.bool()

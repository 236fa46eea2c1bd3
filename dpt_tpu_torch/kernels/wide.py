"""Paired-children BVH: host packing and the nearest / any-hit walk (K2).

Counterpart of `dpt_tpu/kernels/pallas_wide.py` (`traversal="pallas"`).

  - `pack_wide` builds the same tables as the JAX package's packer: one
    16-lane record per internal node of the binary BVH, holding BOTH
    children's AABBs (lanes 0-11: Lmin, Lmax, Rmin, Rmax), their pointers
    (lanes 12-13: >= 0 an internal record id, < 0 the leaf row -(row+1))
    and an 8-bit per-octant "left is nearer" mask (lane 14), eight records
    to a 128-float row; plus row-aligned leaves as in the quad layout
    (1 row = up to 8 triangles x 16 lanes (v0, e1, e2, oid, valid)).
  - `wide_nearest` / `wide_occluded` launch the hand-written CUDA kernel
    (csrc/wide_traverse.cu) for CUDA tensors and run the plain PyTorch walk
    (`wide_nearest_reference` / `wide_occluded_reference`) for CPU tensors.
    There is no fallback between the two: a CUDA tensor launches the kernel
    or raises.

Both walks compute what the TPU kernel computes, one ray at a time instead
of the TPU's interleaved packet walks: both children's slabs are tested
from one record, a leaf child is intersected at once (left before right,
slots 0..7, strict `t < best_t`), internal children are pushed far first so
the near one pops first, and the ray's own direction octant picks the near
bit (the TPU kernel votes per tile).  The slab and Möller–Trumbore
arithmetic is the quad walk's, in the same order, with eps fixed at 1e-6
(pallas_wide.py:293, :310); the kernel is built with `-fmad=false`, so on
the card kernel and plain walk agree exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpt_tpu_torch.kernels.quad import (
    KERNEL_STACK,
    T_MAX,
    _leaf_tests,
    _safe_inv,
    _slab,
)
from dpt_tpu_torch.scene.scene import resolve_device, to_device

# Kernel launches per mode.  Each wrapper adds one where it launches the
# CUDA kernel and nowhere else; the plain walk does not count.
launch_counts = {"nearest": 0, "occluded": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class WideAccel:
    """Paired-children BVH + row-aligned leaves, packed for the K2 walk."""

    nodes: torch.Tensor  # [ceil(I/8), 128] f32 — 8 internal records/row
    tris: torch.Tensor  # [n_leaf_rows, 128] f32 — 1 leaf/row, 8 tris x 16
    n_internal: int
    # Internal-node depth: only internal children are pushed and each pop
    # pushes at most two, so the stack never holds more than max_depth + 1.
    max_depth: int = 0

    def to(self, device) -> "WideAccel":
        return to_device(self, device)


_OCT_SIGNS = np.array(
    [[1.0 if o & 4 else -1.0,
      1.0 if o & 2 else -1.0,
      1.0 if o & 1 else -1.0] for o in range(8)],
    np.float32,
)


def _fill_leaf_row(trows, row, tids, v0, v1, v2):
    trows[row, :len(tids), 0:3] = v0[tids]
    trows[row, :len(tids), 3:6] = v1[tids] - v0[tids]
    trows[row, :len(tids), 6:9] = v2[tids] - v0[tids]
    trows[row, :len(tids), 9] = tids.astype(np.float32)
    trows[row, :len(tids), 10] = 1.0


def _internal_depth(left, right, is_leaf) -> int:
    """Internal-node depth of node 0 (leaves count 0), as pallas_wide.py
    :176-199 computes it, including the explicit post-order walk for trees
    whose children may have smaller ids than their parent."""
    n = left.shape[0]
    if n == 0:
        return 0
    depth = np.zeros(n, np.int64)
    for nid in range(n - 1, -1, -1):
        if is_leaf[nid]:
            continue
        l, r = left[nid], right[nid]
        if l > nid and r > nid:
            depth[nid] = 1 + max(depth[l], depth[r])
        else:
            break
    else:
        return int(depth[0])
    depth[:] = 0
    stack = [(0, False)]
    while stack:
        nid, expanded = stack.pop()
        if is_leaf[nid]:
            continue
        if expanded:
            depth[nid] = 1 + max(depth[left[nid]], depth[right[nid]])
        else:
            stack.append((nid, True))
            stack.append((int(left[nid]), False))
            stack.append((int(right[nid]), False))
    return int(depth[0])


def pack_wide(bvh, v0, v1, v2, device="cuda") -> WideAccel:
    """Pack a binary accel.bvh.BVH into the paired-children layout.

    The tables are byte-identical to `dpt_tpu.kernels.pallas_wide.pack_wide`
    (internal records in node-id order, leaf rows in node-id order; a
    single-leaf tree gets one synthesized record whose children are the
    leaf row and an empty row); returns tensors on `device`.
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
        raise ValueError("the paired-children layout requires "
                         "bvh_leaf_size <= 8")
    internal_ids = np.cumsum(~is_leaf) - 1  # valid where ~is_leaf
    leaf_rows = np.cumsum(is_leaf) - 1  # valid where is_leaf
    I = int((~is_leaf).sum())
    L = int(is_leaf.sum())

    rec = np.zeros((max(I, 1), 16), np.float32)
    if I == 0:
        # Degenerate single-leaf tree: one internal record whose children
        # are leaf row 0 and the empty row 1.
        rec[0, 0:3] = rec[0, 6:9] = nmin[0]
        rec[0, 3:6] = rec[0, 9:12] = nmax[0]
        rec[0, 12] = -1.0
        rec[0, 13] = -2.0
        rec[0, 14] = 255.0
        I, L = 1, 2
    else:
        nodes_i = np.nonzero(~is_leaf)[0]
        rid = internal_ids[nodes_i]
        l, r = left[nodes_i], right[nodes_i]

        def ptr_of(c):
            return np.where(is_leaf[c], -(leaf_rows[c] + 1),
                            internal_ids[c]).astype(np.float32)

        rec[rid, 0:3] = nmin[l]
        rec[rid, 3:6] = nmax[l]
        rec[rid, 6:9] = nmin[r]
        rec[rid, 9:12] = nmax[r]
        rec[rid, 12] = ptr_of(l)
        rec[rid, 13] = ptr_of(r)
        center = 0.5 * (nmin + nmax)
        lc, rc = center[l], center[r]
        mask = np.zeros(I, np.float32)
        for o in range(8):
            left_near = (lc @ _OCT_SIGNS[o]) <= (rc @ _OCT_SIGNS[o])
            mask += np.where(left_near, float(1 << o), 0.0)
        rec[rid, 14] = mask

    nodes = np.zeros((-(-I // 8), 128), np.float32)
    nodes.reshape(-1, 16)[:I] = rec[:I]

    tris = np.zeros((max(L, 1), 128), np.float32)
    trows = tris.reshape(-1, 8, 16)
    if (~is_leaf).sum() == 0:
        _fill_leaf_row(trows, 0, order[right[0]:right[0] + counts[0]][:8],
                       v0, v1, v2)
    else:
        for nid in np.nonzero(is_leaf)[0]:
            first, c = right[nid], counts[nid]
            _fill_leaf_row(trows, leaf_rows[nid], order[first:first + c],
                           v0, v1, v2)

    return WideAccel(
        nodes=torch.as_tensor(nodes, device=device),
        tris=torch.as_tensor(tris, device=device),
        n_internal=I,
        max_depth=_internal_depth(left, right, is_leaf),
    )


def check_stack(accel: WideAccel, cfg) -> None:
    """Stack guard (pallas_wide.py:507-512), also bounded by the kernel's
    fixed per-thread capacity."""
    need = accel.max_depth + 2
    if need > cfg.bvh_stack_depth or need > KERNEL_STACK:
        raise ValueError(
            f"BVH depth {accel.max_depth} needs stack_depth >= {need}, "
            f"got {cfg.bvh_stack_depth} (kernel capacity {KERNEL_STACK})"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch walk: per-ray stack, vectorised over the live rays.
# ---------------------------------------------------------------------------


def _walk_reference(origin, direction, max_dist, accel: WideAccel,
                    occluded: bool, stack_depth: int, stats=None):
    """Per-ray ordered stack walk over `accel`, vectorised over the rays
    still walking.  Returns (t [R] f32, tri [R] int32) for nearest mode and
    (unused, occ [R] int32) for occluded mode, as the kernel does.  With a
    `stats` dict, adds the records visited and triangles tested to its
    "node_visits" and "tri_tests"."""
    R = origin.shape[0]
    dev = origin.device
    out_t = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    out_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    records = accel.nodes.reshape(-1, 16)
    trows = accel.tris.reshape(-1, 8, 16)

    o, d, md = origin, direction, max_dist
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

    while n:
        visits += n
        rows = torch.arange(n, device=dev)
        ray = (o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2])
        sp = sp - 1
        rec = records[stack[rows, sp]]  # [n, 16]
        lptr, rptr = rec[:, 12], rec[:, 13]
        hits = []
        for b in (0, 6):
            tn, tf = _slab(rec, b, ray)
            bound = md if occluded else best_t
            cull = (tn < bound) if occluded else (tn <= bound)
            hits.append((tn <= tf) & (tf >= 0.0) & cull)
        lhit, rhit = hits

        # Leaf children resolve at once, left before right.
        for hit, ptr in ((lhit, lptr), (rhit, rptr)):
            sel = torch.nonzero(hit & (ptr < 0.0) & ~occ).squeeze(1)
            if sel.numel() == 0:
                continue
            tests += 8 * sel.numel()
            row = (-ptr[sel] - 1.0).to(torch.int64)
            th, tt, toid = _leaf_tests(o[sel], d[sel], trows[row])
            if occluded:
                occ[sel] = (th & (tt < md[sel][:, None])).any(dim=1)
            else:
                # Strict t < best_t updates in slot order == the first
                # minimum over the hit slots, if below best_t.
                tm = torch.where(th, tt, torch.full_like(tt, float("inf")))
                m, k = torch.min(tm, dim=1)
                upd = m < best_t[sel]
                best_t[sel] = torch.where(upd, m, best_t[sel])
                best_i[sel] = torch.where(
                    upd, toid.gather(1, k[:, None])[:, 0], best_i[sel])

        # Internal children: far first, so the near one pops first.
        push_l = lhit & (lptr >= 0.0)
        push_r = rhit & (rptr >= 0.0)
        left_near = ((rec[:, 14].to(torch.int64) >> octant) & 1) == 1
        lid, rid = lptr.to(torch.int64), rptr.to(torch.int64)
        first = torch.where(push_l & push_r,
                            torch.where(left_near, rid, lid),
                            torch.where(push_l, lid, rid))
        second = torch.where(left_near, lid, rid)
        do1 = push_l | push_r
        do2 = push_l & push_r
        stack[rows[do1], sp[do1]] = first[do1]
        sp = sp + do1.long()
        stack[rows[do2], sp[do2]] = second[do2]
        sp = sp + do2.long()

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
    return out_t, out_i


def wide_nearest_reference(origin, direction, accel: WideAccel, cfg,
                           stats=None):
    """Plain PyTorch nearest hit: (hit, t, tri)."""
    check_stack(accel, cfg)
    md = torch.zeros((origin.shape[0],), dtype=torch.float32,
                     device=origin.device)
    t, tri = _walk_reference(origin, direction, md, accel, False,
                             cfg.bvh_stack_depth, stats)
    hit = t < T_MAX
    return hit, t, torch.where(hit, tri, torch.zeros_like(tri))


def wide_occluded_reference(origin, direction, max_dist, accel: WideAccel,
                            cfg, stats=None):
    """Plain PyTorch any-hit query: occluded [R] bool."""
    check_stack(accel, cfg)
    _, occ = _walk_reference(origin, direction, max_dist, accel, True,
                             cfg.bvh_stack_depth, stats)
    return occ.bool()


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.
# ---------------------------------------------------------------------------


def _check_inputs(origin, direction, max_dist, accel: WideAccel):
    from dpt_tpu_torch.kernels.build import check_rays

    check_rays(origin, direction, max_dist)
    dev = origin.device
    for name, x in (("nodes", accel.nodes), ("tris", accel.tris)):
        if x.dtype != torch.float32:
            raise TypeError(f"accel.{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"accel.{name} is on {x.device}, rays on {dev}")
        if x.dim() != 2 or x.shape[1] != 128:
            raise ValueError(f"accel.{name} must have shape [rows, 128]")
    if accel.nodes.shape[0] * 8 < accel.n_internal:
        raise ValueError("accel.nodes must hold n_internal records")


def _launch(origin, direction, max_dist, accel: WideAccel, occluded: bool):
    """Launch K2 on the current stream: (t [R] f32, tri/occ [R] int32)."""
    from dpt_tpu_torch.kernels.build import launch_walk

    out = launch_walk("wide_traverse", origin, direction, max_dist,
                      accel.nodes, accel.tris, occluded)
    if origin.shape[0]:
        launch_counts["occluded" if occluded else "nearest"] += 1
    return out


def _dispatch(origin, direction, max_dist, accel, cfg, occluded: bool):
    check_stack(accel, cfg)
    _check_inputs(origin, direction, max_dist, accel)
    if origin.is_cuda:
        return _launch(origin, direction, max_dist, accel, occluded)
    if origin.device.type != "cpu":
        raise ValueError(f"wide walk: unsupported device {origin.device}")
    return _walk_reference(origin, direction, max_dist, accel, occluded,
                           cfg.bvh_stack_depth)


def wide_nearest(origin, direction, accel: WideAccel, cfg):
    """Nearest hit via the paired-children walk: (hit [R] bool, t [R] f32,
    tri [R] int32).  CUDA tensors launch the kernel; CPU tensors take the
    plain walk."""
    md = torch.zeros((origin.shape[0],), dtype=torch.float32,
                     device=origin.device)
    t, tri = _dispatch(origin, direction, md, accel, cfg, False)
    hit = t < T_MAX
    return hit, t, torch.where(hit, tri, torch.zeros_like(tri))


def wide_occluded(origin, direction, max_dist, accel: WideAccel, cfg):
    """Any-hit query via the paired-children walk: occluded [R] bool (a hit
    with t < max_dist; lanes with max_dist <= 0 are never occluded)."""
    _, occ = _dispatch(origin, direction, max_dist, accel, cfg, True)
    return occ.bool()

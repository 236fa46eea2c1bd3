"""Host BVH builders — top-down median split and binned SAH, SoA layout.

Counterpart of `dpt_tpu/accel/bvh.py`: a copy of its numpy builders, so both
packages build byte-identical trees.  As in the JAX package, meshes of
NATIVE_MIN_TRIS triangles or more build in C++ (utils/native.py, the same
trees byte for byte) unless `use_native=False`; without `g++` they build
in numpy.  Splitting policy as in the reference's
recursive CPU builder (BoundingVolumeHierarchy.cpp:25-82); leaves hold up to
`leaf_size` triangles; the index buffer is not mutated — `tri_order` holds
the permutation and leaves store ranges into it.

Node encoding: internal → left/right = child node ids;
leaf → left = -count, right = first index into tri_order.

`build_accel` builds the accel of every traversal, from the host builders
or from the LBVH built on the scene's device (accel/lbvh.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Meshes from this size build with the native runtime (the JAX package's
# threshold, dpt_tpu/accel/bvh.py:63,150).
NATIVE_MIN_TRIS = 1024


@dataclasses.dataclass
class BVH:
    """SoA BVH: host numpy arrays from the host builders (packing is host
    work), tensors on the scene's device from the LBVH and for the
    per-ray walk (accel/traverse.py)."""

    node_min: np.ndarray  # [N, 3] f32
    node_max: np.ndarray  # [N, 3] f32
    node_left: np.ndarray  # [N] i32 (-count for leaves)
    node_right: np.ndarray  # [N] i32 (child id | first tri_order slot)
    tri_order: np.ndarray  # [T] i32 permutation of triangle ids

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]


def build_bvh_median(vertices: np.ndarray, indices: np.ndarray,
                     leaf_size: int = 4, use_native: bool = True) -> BVH:
    """Median-split BVH (semantics of BoundingVolumeHierarchy.cpp:25-82)."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    n_tri = indices.shape[0]
    assert n_tri > 0

    if use_native and n_tri >= NATIVE_MIN_TRIS:
        from dpt_tpu_torch.utils.native import native_build_bvh

        # None only without g++; a native failure raises.
        out = native_build_bvh(vertices, indices, leaf_size)
        if out is not None:
            return BVH(*out)

    tri = vertices[indices]  # [T, 3, 3]
    tri_min = tri.min(axis=1)
    tri_max = tri.max(axis=1)
    centroid = tri.mean(axis=1)

    # Worst-case node count for leaf_size>=1 is 2*ceil(T/1)-1; allocate for
    # leaf_size=1 and trim.
    max_nodes = max(2 * n_tri - 1, 1)
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    node_left = np.zeros(max_nodes, np.int32)
    node_right = np.zeros(max_nodes, np.int32)
    order = np.arange(n_tri, dtype=np.int32)

    n_nodes = 0
    # Iterative pre-order build: stack of (start, end, node_id).
    stack = [(0, n_tri, 0)]
    n_nodes = 1
    while stack:
        start, end, nid = stack.pop()
        ids = order[start:end]
        node_min[nid] = tri_min[ids].min(axis=0)
        node_max[nid] = tri_max[ids].max(axis=0)
        count = end - start
        if count <= leaf_size:
            node_left[nid] = -count
            node_right[nid] = start
            continue
        ext = node_max[nid] - node_min[nid]
        axis = int(np.argmax(ext))
        # Median split along the longest axis (BoundingVolumeHierarchy.cpp:56-72).
        key = centroid[ids, axis]
        perm = np.argsort(key, kind="stable")
        order[start:end] = ids[perm]
        mid = start + count // 2
        left_id = n_nodes
        right_id = n_nodes + 1
        n_nodes += 2
        node_left[nid] = left_id
        node_right[nid] = right_id
        # Push right then left so left pops first (pre-order-ish numbering).
        stack.append((mid, end, right_id))
        stack.append((start, mid, left_id))

    return BVH(
        node_min=node_min[:n_nodes],
        node_max=node_max[:n_nodes],
        node_left=node_left[:n_nodes],
        node_right=node_right[:n_nodes],
        tri_order=order,
    )


def build_bvh_sah(vertices: np.ndarray, indices: np.ndarray,
                  leaf_size: int = 8, n_bins: int = 16,
                  use_native: bool = True) -> BVH:
    """Binned surface-area-heuristic BVH (host; C++ for large meshes).

    Upgrade over the reference's median split (BoundingVolumeHierarchy.cpp:
    56-72): per node, centroids are binned along each axis and the split
    minimizing N_L*area(L) + N_R*area(R) is taken.  Same node encoding as
    build_bvh_median.  The numpy path of the JAX package, byte for byte;
    large meshes take the native builder (the same tree).
    """
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    n_tri = indices.shape[0]
    assert n_tri > 0

    if use_native and n_tri >= NATIVE_MIN_TRIS:
        from dpt_tpu_torch.utils.native import native_build_bvh_sah

        out = native_build_bvh_sah(vertices, indices, leaf_size, n_bins)
        if out is not None:
            return BVH(*out)

    tri = vertices[indices]
    tri_min = tri.min(axis=1)
    tri_max = tri.max(axis=1)
    centroid = tri.mean(axis=1)

    max_nodes = max(2 * n_tri - 1, 1)
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    node_left = np.zeros(max_nodes, np.int32)
    node_right = np.zeros(max_nodes, np.int32)
    order = np.arange(n_tri, dtype=np.int32)

    def half_area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    stack = [(0, n_tri, 0)]
    n_nodes = 1
    while stack:
        start, end, nid = stack.pop()
        ids = order[start:end]
        node_min[nid] = tri_min[ids].min(axis=0)
        node_max[nid] = tri_max[ids].max(axis=0)
        count = end - start
        if count <= leaf_size:
            node_left[nid] = -count
            node_right[nid] = start
            continue

        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        ext = cmax - cmin
        best = None  # (cost, axis, bin_idx, bin_of_tri)
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            scale = n_bins * (1.0 - 1e-6) / ext[axis]
            b = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            cnt = np.bincount(b, minlength=n_bins)
            # Per-bin bounds via maximum.at / minimum.at scatters.
            bmin = np.full((n_bins, 3), np.inf, np.float32)
            bmax = np.full((n_bins, 3), -np.inf, np.float32)
            np.minimum.at(bmin, b, tri_min[ids])
            np.maximum.at(bmax, b, tri_max[ids])
            # Prefix (left) and suffix (right) sweeps over split planes.
            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)
            rcnt = count - lcnt
            # Split after bin k (k = 0..n_bins-2).
            cost = (
                lcnt[:-1] * half_area(lmin[:-1], lmax[:-1])
                + rcnt[:-1] * half_area(rmin[1:], rmax[1:])
            )
            cost = np.where((lcnt[:-1] == 0) | (rcnt[:-1] == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
                best = (cost[k], axis, k, b)

        if best is None:
            # Degenerate centroids: median split on the longest node axis.
            axis = int(np.argmax(node_max[nid] - node_min[nid]))
            perm = np.argsort(c[:, axis], kind="stable")
            order[start:end] = ids[perm]
            mid = start + count // 2
        else:
            _, axis, k, b = best
            go_left = b <= k
            order[start:end] = np.concatenate([ids[go_left], ids[~go_left]])
            mid = start + int(go_left.sum())

        left_id = n_nodes
        right_id = n_nodes + 1
        n_nodes += 2
        node_left[nid] = left_id
        node_right[nid] = right_id
        stack.append((mid, end, right_id))
        stack.append((start, mid, left_id))

    return BVH(
        node_min=node_min[:n_nodes],
        node_max=node_max[:n_nodes],
        node_left=node_left[:n_nodes],
        node_right=node_right[:n_nodes],
        tri_order=order,
    )


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def host_bvh(bvh: BVH) -> BVH:
    """The tree as host numpy arrays."""
    return BVH(*(_numpy(getattr(bvh, f.name))
                 for f in dataclasses.fields(BVH)))


def device_bvh(bvh: BVH, device) -> BVH:
    """The tree as tensors on `device` (the dtypes kept)."""
    return BVH(*(torch.as_tensor(_numpy(getattr(bvh, f.name)), device=device)
                 for f in dataclasses.fields(BVH)))


def prune_bvh(bvh: BVH) -> BVH:
    """Drop the nodes unreachable from the root and renumber the children;
    a host BVH (numpy) of the same tree.

    The LBVH's range-leaf collapse (accel/lbvh.py) leaves the interior and
    single-triangle slots of collapsed subtrees in place; packing those
    dead slots would waste about 8x the leaf rows, so the packed walks
    prune first."""
    left = _numpy(bvh.node_left)
    right = _numpy(bvh.node_right)
    n = left.shape[0]
    reach = np.zeros(n, bool)
    stack = [0]
    while stack:
        nid = stack.pop()
        if reach[nid]:
            continue
        reach[nid] = True
        if left[nid] >= 0:  # internal
            stack.append(int(left[nid]))
            stack.append(int(right[nid]))
    remap = np.cumsum(reach) - 1  # old id -> new id (valid where reach)
    keep = np.nonzero(reach)[0]
    new_left = left[keep].copy()
    new_right = right[keep].copy()
    internal = new_left >= 0
    new_left[internal] = remap[new_left[internal]]
    new_right[internal] = remap[new_right[internal]]
    return BVH(node_min=_numpy(bvh.node_min)[keep],
               node_max=_numpy(bvh.node_max)[keep],
               node_left=new_left, node_right=new_right,
               tri_order=_numpy(bvh.tri_order))


#: Traversals that walk a packed table built on the host; the LBVH is
#: pruned for these (as in the JAX package, `threaded` too).
PRUNED_TRAVERSALS = ("quad", "pallas", "threaded")


def build_accel(scene, cfg):
    """The accel cfg asks for, on the scene's device: None for 'brute', a
    QuadAccel for 'quad', a WideAccel for 'pallas', and for 'bvh', 'packet'
    and 'threaded' the binary BVH the per-ray walk takes
    (accel/traverse.py).  bvh_builder 'median' and 'sah' build on the
    host (natively from NATIVE_MIN_TRIS triangles); 'lbvh' builds on the
    scene's device, pruned for the PRUNED_TRAVERSALS when its leaves hold
    more than one triangle."""
    if cfg.traversal == "brute":
        return None
    if cfg.traversal not in ("quad", "pallas", "bvh", "packet", "threaded"):
        raise ValueError(f"unknown traversal mode: {cfg.traversal}")
    if cfg.bvh_builder == "lbvh":
        from dpt_tpu_torch.accel.lbvh import build_lbvh

        bvh = build_lbvh(scene.vertices, scene.indices,
                         leaf_size=cfg.bvh_leaf_size)
        if cfg.bvh_leaf_size > 1 and cfg.traversal in PRUNED_TRAVERSALS:
            bvh = prune_bvh(bvh)
    elif cfg.bvh_builder in ("median", "sah"):
        build = (build_bvh_median if cfg.bvh_builder == "median"
                 else build_bvh_sah)
        bvh = build(scene.vertices.detach().cpu().numpy(),
                    scene.indices.detach().cpu().numpy(),
                    leaf_size=cfg.bvh_leaf_size)
    else:
        raise ValueError(f"unknown bvh_builder: {cfg.bvh_builder}")
    if cfg.traversal in ("bvh", "packet", "threaded"):
        return device_bvh(bvh, scene.device)
    bvh = host_bvh(bvh)
    v = scene.vertices.detach().cpu().numpy()
    idx = scene.indices.detach().cpu().numpy()
    corners = (v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]])
    if cfg.traversal == "pallas":
        from dpt_tpu_torch.kernels.wide import pack_wide

        return pack_wide(bvh, *corners, device=scene.device)
    from dpt_tpu_torch.kernels.quad import pack_quad

    return pack_quad(bvh, *corners, device=scene.device)

"""LBVH — a linear BVH built with torch ops on the scene's device.

Counterpart of `dpt_tpu/accel/lbvh.py`: 30-bit Morton codes over quantised
triangle centroids, one stable argsort, Karras-style linking of the
internal nodes (binary searches over common-prefix lengths, vectorised over
all nodes), then bottom-up AABB fitting by fixed-point iteration.  The
same arithmetic in the same order, so both packages build byte-identical
trees.

The JAX package's uint32 arithmetic is done here in int64 holding values
in [0, 2**32) (`torch.uint32` has no shift or add kernels on the CPU).
The count of leading zeros is the float64 exponent of the value (exact for
every value below 2**53), where the JAX package counts bits.

Output is an `accel.bvh.BVH` of tensors on the scene's device, in the
encoding of the host builders (internal: left / right = child ids; leaf:
left = -count, right = first slot of tri_order).  Layout: internal nodes
at ids [0, T-2] (root 0), single-triangle leaves at [T-1, 2T-2], leaf
T-1+k covering sorted slot k; with leaf_size > 1 the internal nodes whose
range holds at most leaf_size triangles become range leaves in place and
their subtrees dead slots (`accel.bvh.prune_bvh` drops them).

Reference for the algorithm: T. Karras, "Maximizing Parallelism in the
Construction of BVHs, Octrees, and k-d Trees" (HPG 2012).
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.accel.bvh import BVH

_BIG = 3e38


def _expand_bits_10(x):
    """Spread the low 10 bits of x so consecutive bits are 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(q):
    """Interleave quantised coords q [T, 3] int64 (10 bits each) → [T]
    int64 codes in [0, 2**30)."""
    return ((_expand_bits_10(q[:, 0]) << 2)
            | (_expand_bits_10(q[:, 1]) << 1)
            | _expand_bits_10(q[:, 2]))


def _clz32(x):
    """Leading zeros of x [int64, values in [0, 2**32)] as a 32-bit word:
    32 minus the bit length, which is the exponent frexp gives (0 for 0)."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def _delta_fn(codes, T):
    """delta(i, j): common-prefix length of the augmented keys (morton,
    index); the index tie-break makes keys unique.  Out-of-range j → -1
    (Karras's convention)."""

    def delta(i, j):
        j_in = (j >= 0) & (j < T)
        j_c = j.clamp(0, T - 1)
        x = codes[i] ^ codes[j_c]
        ix = i ^ j_c
        d = torch.where(x == 0, 32 + _clz32(ix), _clz32(x))
        return torch.where(j_in, d, torch.full_like(d, -1))

    return delta


def _ceil_half(x):
    return -((-x) // 2)


def build_lbvh(vertices, indices, leaf_size: int = 1) -> BVH:
    """LBVH of a triangle soup on the device of `vertices`.

    vertices: [V, 3] f32; indices: [T, 3] int.  Returns a BVH of tensors
    with 2T-1 node slots: node_min / node_max f32, node_left / node_right /
    tri_order int32.  leaf_size > 1 turns every internal node whose sorted
    range holds at most leaf_size triangles into a range leaf in place
    (Karras ranges are contiguous in Morton order).
    """
    vertices = vertices.detach()
    dev = vertices.device
    tri = vertices[indices.long()]  # [T, 3, 3]
    T = tri.shape[0]
    # jnp.mean: the sum over the three corners, then one division.
    centroid = (tri[:, 0] + tri[:, 1] + tri[:, 2]) / 3.0
    flat = tri.reshape(-1, 3)
    lo = flat.min(dim=0).values
    hi = flat.max(dim=0).values
    scale = 1.0 / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((centroid - lo) * scale * 1024.0, 0.0, 1023.0).to(
        torch.int64)
    codes_unsorted = morton3d(q)
    order = torch.argsort(codes_unsorted, stable=True)
    codes = codes_unsorted[order]

    tri_lo = tri.min(dim=1).values[order]  # sorted leaf AABBs
    tri_hi = tri.max(dim=1).values[order]
    order32 = order.to(torch.int32)

    if T == 1:
        return BVH(node_min=tri_lo, node_max=tri_hi,
                   node_left=torch.tensor([-1], dtype=torch.int32,
                                          device=dev),
                   node_right=torch.tensor([0], dtype=torch.int32,
                                           device=dev),
                   tri_order=order32)

    delta = _delta_fn(codes, T)
    i = torch.arange(T - 1, dtype=torch.int64, device=dev)

    # Direction of each internal node's range.
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i, i - d)

    # Upper bound on the range length by doubling (lengths <= T).
    n_bits = max((T - 1).bit_length() + 1, 1)
    l_max = torch.full_like(i, 2)
    for _ in range(n_bits):
        cond = delta(i, i + l_max * d) > delta_min
        l_max = torch.where(cond, l_max * 2, l_max)

    # Binary search of the exact range length l.
    length = torch.zeros_like(i)
    t_step = l_max // 2
    for _ in range(n_bits):
        cand = length + t_step
        ok = (delta(i, i + cand * d) > delta_min) & (t_step > 0)
        length = torch.where(ok, cand, length)
        t_step = t_step // 2
    j = i + length * d  # the other end of the range
    delta_node = delta(i, j)

    # Binary search of the split: t walks ceil(l/2), ceil(t/2), ..., 1,
    # then 0 (each node takes t == 1 exactly once).
    s = torch.zeros_like(i)
    t_step = _ceil_half(length)
    for _ in range(n_bits + 1):
        ok = (t_step > 0) & (delta(i, i + (s + t_step) * d) > delta_node)
        s = torch.where(ok, s + t_step, s)
        t_step = torch.where(t_step > 1, _ceil_half(t_step),
                             torch.zeros_like(t_step))
    gamma = i + s * d + torch.clamp(d, max=0)

    left_is_leaf = torch.minimum(i, j) == gamma
    right_is_leaf = torch.maximum(i, j) == gamma + 1
    left_child = torch.where(left_is_leaf, (T - 1) + gamma, gamma)
    right_child = torch.where(right_is_leaf, (T - 1) + gamma + 1, gamma + 1)

    # Range-leaf collapse: internal node i covers sorted slots
    # [min(i, j), max(i, j)]; with at most leaf_size of them it becomes a
    # leaf (left = -count, right = first slot) in place.  The topmost
    # collapsed node shadows its subtree, whose slots go dead.
    count = length + 1
    first = torch.minimum(i, j)
    collapse = count <= leaf_size
    int_left = torch.where(collapse, -count, left_child)
    int_right = torch.where(collapse, first, right_child)
    node_left = torch.cat([int_left, torch.full((T,), -1, dtype=torch.int64,
                                                device=dev)])
    node_right = torch.cat([int_right, torch.arange(T, dtype=torch.int64,
                                                    device=dev)])

    # Bottom-up AABB fit by fixed-point iteration over the original child
    # graph (a collapsed leaf still needs the union of its subtree): repeat
    # internal = union(children) until nothing changes (<= depth passes;
    # one host sync a pass).
    node_min = torch.cat([torch.full((T - 1, 3), _BIG, device=dev), tri_lo])
    node_max = torch.cat([torch.full((T - 1, 3), -_BIG, device=dev), tri_hi])
    while True:
        new_min = torch.minimum(node_min[left_child], node_min[right_child])
        new_max = torch.maximum(node_max[left_child], node_max[right_child])
        changed = bool(((new_min != node_min[:T - 1]).any()
                        | (new_max != node_max[:T - 1]).any()))
        node_min = torch.cat([new_min, node_min[T - 1:]])
        node_max = torch.cat([new_max, node_max[T - 1:]])
        if not changed:
            break

    return BVH(node_min=node_min, node_max=node_max,
               node_left=node_left.to(torch.int32),
               node_right=node_right.to(torch.int32), tri_order=order32)

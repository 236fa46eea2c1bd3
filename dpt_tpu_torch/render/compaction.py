"""Ray-stream coherence sorting.

Counterpart of `dpt_tpu/render/compaction.py`.  Rays are sorted by the key

    [ direction octant | 30-bit Morton code of origin ], inactive rays last

so that neighbouring rays walk similar subtrees and masked lanes cluster.
Keys are int64 tensors holding uint32 values; the JAX package's uint32
arithmetic is reproduced exactly, including the wrap of `octant << 30`,
where the x-sign bit (4 << 30 = 2**32) overflows to 0.  Every sort is
stable, as `jnp.argsort` is.
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.render.rng import MASK32


def _part1by2(x):
    """Spread the low 10 bits of x so there are two zero bits between each
    (standard Morton bit-interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3d(p, bounds_min, bounds_max, bits: int = 10):
    """30-bit Morton code [R] int64 of points p [R, 3] within the bounds."""
    scale = float((1 << bits) - 1)
    ext = torch.clamp(bounds_max - bounds_min, min=1e-20)
    q = torch.clamp((p - bounds_min) / ext, 0.0, 1.0)
    cell = (q * scale).to(torch.int64)
    return (
        (_part1by2(cell[:, 0]) << 2)
        | (_part1by2(cell[:, 1]) << 1)
        | _part1by2(cell[:, 2])
    )


def ray_sort_key(origin, direction, active, bounds_min, bounds_max,
                 octant_major: bool = True):
    """Coherence key [R] int64 in [0, 2**32): inactive rays sort last;
    active rays group by direction octant, then origin locality."""
    code = morton3d(origin, bounds_min, bounds_max)
    if octant_major:
        octant = (
            (direction[:, 0] >= 0).long() * 4
            + (direction[:, 1] >= 0).long() * 2
            + (direction[:, 2] >= 0).long()
        )
        key = ((octant << 30) & MASK32) | (code & ((1 << 30) - 1))
    else:
        key = code
    return torch.where(active, key, torch.full_like(key, MASK32))


def sort_permutation(origin, direction, active, bounds_min, bounds_max,
                     octant_major: bool = True):
    """Permutation that orders rays by coherence key (stable)."""
    key = ray_sort_key(origin, direction, active, bounds_min, bounds_max,
                       octant_major=octant_major)
    return torch.argsort(key, stable=True)


def scatter_back(perm, *arrays):
    """Inverse the gather `a[perm]` for each array: out[perm[i]] = a[i]."""
    out = []
    for a in arrays:
        b = torch.zeros_like(a)
        b[perm] = a
        out.append(b)
    return tuple(out)


def sorted_nearest(nearest, bounds_min, bounds_max):
    """Wrap a nearest-hit closure with coherence sorting.

    Masked rays (origin moved to 1e9 by integrator._masked_query) are the
    inactive ones and sink to the tail.
    """

    def wrapped(o, d):
        active = (o.abs() < 1e8).all(dim=-1)
        perm = sort_permutation(o, d, active, bounds_min, bounds_max)
        res = nearest(o[perm], d[perm])
        hit, t, tri = scatter_back(perm, res["hit"], res["t"], res["tri"])
        return {"hit": hit, "t": t, "tri": tri}

    # The raw closure, for streams that are already coherent (the primary
    # stream keeps raster order).
    wrapped.unsorted = nearest
    return wrapped


def sorted_occluded(occluded, bounds_min, bounds_max):
    """Wrap an any-hit closure with coherence sorting; max_dist <= 0 marks
    masked lanes, which sort last."""

    def wrapped(o, d, max_dist):
        active = max_dist > 0.0
        perm = sort_permutation(o, d, active, bounds_min, bounds_max)
        occ = occluded(o[perm], d[perm], max_dist[perm])
        (occ,) = scatter_back(perm, occ)
        return occ

    return wrapped

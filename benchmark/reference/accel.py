"""Nearest-hit and any-hit queries for the plain reference.

A complete binary tree over the triangles in Morton order of their
centroids: each leaf holds LEAF consecutive triangles, and each inner node
the union of its two children's boxes (a heap, built bottom-up with one
min / max a level).  A query walks the tree breadth first: every (ray,
node) pair whose box the ray's segment meets passes its two children on to
the next level, and the leaves' triangles are tested with Möller–Trumbore
in the arithmetic of the brute-force search.  The boxes are padded, so the
tree only skips triangles no ray can hit, and the answer is the
brute-force answer: the nearest t, ties to the lowest triangle index.

Plain PyTorch; it shares no code with the program under test.
"""

from __future__ import annotations

import torch

LEAF = 4
T_MAX = 1e30
_NO_HIT = torch.iinfo(torch.int64).max
# Ray pairs per block of a query: bounds the memory of a level's pairs.
RAYS_PER_BLOCK = 1 << 18


def _spread10(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


class Tree:
    """The tree of a mesh: vertices [V, 3] float32, indices [T, 3]."""

    def __init__(self, vertices, indices, eps=1e-6):
        v = vertices.detach().float()
        idx = indices.long()
        self.eps = eps
        self.v0 = v[idx[:, 0]]
        self.e1 = v[idx[:, 1]] - self.v0
        self.e2 = v[idx[:, 2]] - self.v0
        n_tri = idx.shape[0]
        corners = v[idx]  # [T, 3, 3]
        cen = corners.mean(dim=1)
        lo, hi = v.min(dim=0).values, v.max(dim=0).values
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-20)).clamp(0.0, 1.0)
        cell = (q * 1023.0).long()
        code = ((_spread10(cell[:, 0]) << 2) | (_spread10(cell[:, 1]) << 1)
                | _spread10(cell[:, 2]))
        order = torch.argsort(code, stable=True)
        n_leaf = -(-n_tri // LEAF)
        self.depth = max(0, (n_leaf - 1).bit_length())
        width = 1 << self.depth
        slots = torch.full((width * LEAF,), -1, dtype=torch.long,
                           device=v.device)
        slots[:n_tri] = order
        self.leaf_tris = slots.view(width, LEAF)
        # Leaf boxes, padded by a share of the scene's size so rounding in
        # the slab test never drops a triangle the plain test would hit.
        pad = 1e-4 * float((hi - lo).abs().max()) + 1e-6
        c = corners[order.clamp(min=0)]  # [T, 3, 3] in leaf order
        c_lo = torch.full((width * LEAF, 3), float("inf"), device=v.device)
        c_hi = torch.full((width * LEAF, 3), float("-inf"), device=v.device)
        c_lo[:n_tri] = c.min(dim=1).values
        c_hi[:n_tri] = c.max(dim=1).values
        lo_l = c_lo.view(width, LEAF, 3).min(dim=1).values - pad
        hi_l = c_hi.view(width, LEAF, 3).max(dim=1).values + pad
        self.lo = [lo_l]
        self.hi = [hi_l]
        while self.lo[0].shape[0] > 1:
            self.lo.insert(0, self.lo[0].view(-1, 2, 3).min(dim=1).values)
            self.hi.insert(0, self.hi[0].view(-1, 2, 3).max(dim=1).values)
        # A node over padding alone has an empty box (lo > hi), which the
        # slab test would read as the whole space.
        self.full = [lo[:, 0] <= hi[:, 0] for lo, hi in zip(self.lo, self.hi)]

    def _pairs(self, o, inv, t_hi):
        """(ray, leaf) pairs whose leaf box the segment [0, t_hi] meets."""
        dev = o.device
        ray = torch.arange(o.shape[0], device=dev)
        node = torch.zeros_like(ray)
        for level in range(self.depth + 1):
            if level:
                node = (node[:, None] * 2
                        + torch.arange(2, device=dev)).reshape(-1)
                ray = ray[:, None].expand(-1, 2).reshape(-1)
            oo, ii = o[ray], inv[ray]
            t0 = (self.lo[level][node] - oo) * ii
            t1 = (self.hi[level][node] - oo) * ii
            tn = torch.minimum(t0, t1).amax(dim=1)
            tf = torch.maximum(t0, t1).amin(dim=1)
            ok = ((tn <= tf) & (tf >= 0.0) & (tn <= t_hi[ray])
                  & self.full[level][node])
            ray, node = ray[ok], node[ok]
        return ray, node

    def _tests(self, o, d, ray, leaf):
        """Möller–Trumbore of each pair's LEAF triangles, in the order and
        arithmetic of the brute-force search: (ray, tri, hit, t)."""
        tri = self.leaf_tris[leaf].reshape(-1)
        ray = ray[:, None].expand(-1, LEAF).reshape(-1)
        keep = tri >= 0
        tri, ray = tri[keep], ray[keep]
        oo, dd = o[ray], d[ray]
        v0, e1, e2 = self.v0[tri], self.e1[tri], self.e2[tri]
        dx, dy, dz = dd.unbind(1)
        e1x, e1y, e1z = e1.unbind(1)
        e2x, e2y, e2z = e2.unbind(1)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        parallel = det.abs() < self.eps
        inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
        tx, ty, tz = (oo - v0).unbind(1)
        u = inv_det * (tx * px + ty * py + tz * pz)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = inv_det * (dx * qx + dy * qy + dz * qz)
        t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
        hit = ((~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
               & (u + v <= 1.0) & (t > self.eps))
        return ray, tri, hit, t

    @staticmethod
    def _inv(d):
        tiny = torch.where(d < 0, -1e-20, 1e-20)
        return 1.0 / torch.where(d.abs() < 1e-20, tiny, d)

    def nearest(self, o, d, active):
        """(hit [R] bool, t [R], tri [R] long; 0 on a miss) of the rays
        where `active`; inactive rays miss."""
        R = o.shape[0]
        dev = o.device
        key = torch.full((R,), _NO_HIT, dtype=torch.int64, device=dev)
        ids = active.nonzero().squeeze(1)
        for s in range(0, ids.numel(), RAYS_PER_BLOCK):
            blk = ids[s:s + RAYS_PER_BLOCK]
            ob, db = o[blk], d[blk]
            t_hi = torch.full((blk.numel(),), T_MAX, device=dev)
            ray, leaf = self._pairs(ob, self._inv(db), t_hi)
            ray, tri, hit, t = self._tests(ob, db, ray, leaf)
            # t > 0 where hit, so its bits order as the floats do.
            k = (t.view(torch.int32).long() << 32) | tri
            k = torch.where(hit, k, torch.full_like(k, _NO_HIT))
            best = torch.full((blk.numel(),), _NO_HIT, dtype=torch.int64,
                              device=dev)
            best.scatter_reduce_(0, ray, k, "amin")
            key[blk] = best
        hit = key != _NO_HIT
        t = (key >> 32).to(torch.int32).view(torch.float32)
        tri = torch.where(hit, key & 0xFFFFFFFF, torch.zeros_like(key))
        return hit, torch.where(hit, t, torch.full_like(t, T_MAX)), tri

    def occluded(self, o, d, max_dist, active):
        """[R] bool: a hit with t < max_dist, for the rays where `active`."""
        R = o.shape[0]
        dev = o.device
        occ = torch.zeros((R,), dtype=torch.bool, device=dev)
        ids = (active & (max_dist > 0)).nonzero().squeeze(1)
        for s in range(0, ids.numel(), RAYS_PER_BLOCK):
            blk = ids[s:s + RAYS_PER_BLOCK]
            ob, db, mb = o[blk], d[blk], max_dist[blk]
            ray, leaf = self._pairs(ob, self._inv(db), mb)
            ray, _, hit, t = self._tests(ob, db, ray, leaf)
            got = torch.zeros((blk.numel(),), dtype=torch.bool, device=dev)
            got[ray[hit & (t < mb[ray])]] = True
            occ[blk] = got
        return occ

// Device helpers shared by the BVH walks K1 (quad_traverse.cu) and K2
// (wide_traverse.cu) and the brute-force search K3 (intersect_nearest.cu):
// the slab test and the Möller–Trumbore leaf-row test, in the arithmetic
// order of the TPU kernels and of the plain PyTorch versions
// (dpt_tpu_torch/kernels/quad.py `_slab`, `_leaf_tests`), and the leaf-row
// test of K1's groups of lanes.  The kernels are built with -fmad=false, so
// these are the same roundings as the plain versions and the two agree
// exactly on the card.
#pragma once

#include <cuda_runtime.h>

namespace dpt {

constexpr int kStack = 64;
constexpr int kBlock = 128;
constexpr float kTMax = 1e30f;
constexpr float kTiny = 1e-20f;
// Möller–Trumbore epsilon hard-coded by both TPU walks
// (pallas_quad.py:610,627; pallas_wide.py:293,310); K3 takes its own.
constexpr float kEps = 1e-6f;

// NaN-propagating min / max (torch.minimum / jnp.minimum semantics): a
// NaN-boxed empty slot can never pass the slab test.  Each is the one PTX
// instruction min.NaN.f32 / max.NaN.f32 (sm_80 and later), where a compare
// and a select per operand took three.  The only result that may differ
// from torch.minimum / torch.maximum is the sign of a zero, as in
// min(-0, +0).  The slab values reach nothing but the comparisons
// tn <= tf, tf >= 0, tn <= best_t and tn < max_dist, where -0 == +0, so the
// walks' results stay exactly the plain walks'.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float safe_inv(float v) {
  const float w = fabsf(v) < kTiny ? (v >= 0.f ? kTiny : -kTiny) : v;
  return 1.0f / w;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab test of the box (min xyz, max xyz) at f[b..b+5].
__device__ __forceinline__ void slab(const float* f, int b, const Ray& r,
                                     float& tn, float& tf) {
  float t0 = (f[b + 0] - r.ox) * r.ix;
  float t1 = (f[b + 3] - r.ox) * r.ix;
  tn = min_nan(t0, t1);
  tf = max_nan(t0, t1);
  t0 = (f[b + 1] - r.oy) * r.iy;
  t1 = (f[b + 4] - r.oy) * r.iy;
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
  t0 = (f[b + 2] - r.oz) * r.iz;
  t1 = (f[b + 5] - r.oz) * r.iz;
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
}

// Möller–Trumbore of ray r against one leaf slot (a, b, c: v0, e1, e2,
// oid, valid), with `eps` in both the parallel test and t > eps.
__device__ __forceinline__ bool slot_test(const float4& a, const float4& b,
                                          const float4& c, const Ray& r,
                                          float eps, float& t) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const bool valid = c.z > 0.5f;

  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool parallel = fabsf(det) < eps;
  const float inv_det = 1.0f / (parallel ? 1.0f : det);
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  const float u = inv_det * (tx * px + ty * py + tz * pz);
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = inv_det * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
  return !parallel && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
         t > eps && valid;
}

// Tests the K slots k0 .. k0+K-1 of a leaf row (8 triangles x 16 floats)
// in slot order.  Nearest mode takes strictly smaller t into (best_t,
// best_i, best_s = the slot); occluded mode returns true at the first hit
// t < md.  The loop is unrolled and each slot's three 16-byte loads are
// issued before the previous slot's test, so a load's latency overlaps a
// test; the updates keep the slot order.
template <bool kOccluded, int K>
__device__ __forceinline__ bool leaf_slots(const float4* __restrict__ tr,
                                           int k0, const Ray& r, float md,
                                           float eps, float& best_t,
                                           int& best_i, int& best_s) {
  const float4* p = tr + 4 * k0;
  float4 a = __ldg(p + 0);  // v0x v0y v0z e1x
  float4 b = __ldg(p + 1);  // e1y e1z e2x e2y
  float4 c = __ldg(p + 2);  // e2z oid valid -
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float4 na, nb, nc;
    if (k + 1 < K) {
      na = __ldg(p + 4 * k + 4);
      nb = __ldg(p + 4 * k + 5);
      nc = __ldg(p + 4 * k + 6);
    }
    float t;
    const bool tri_hit = slot_test(a, b, c, r, eps, t);
    if (kOccluded) {
      if (tri_hit && t < md) return true;
    } else if (tri_hit && t < best_t) {
      best_t = t;
      best_i = static_cast<int>(c.y);
      best_s = k0 + k;
    }
    if (k + 1 < K) {
      a = na;
      b = nb;
      c = nc;
    }
  }
  return false;
}

// All 8 slots of a leaf row, by one thread.
template <bool kOccluded>
__device__ __forceinline__ bool leaf_row(const float4* __restrict__ tr,
                                         const Ray& r, float md, float eps,
                                         float& best_t, int& best_i) {
  int slot;
  return leaf_slots<kOccluded, 8>(tr, 0, r, md, eps, best_t, best_i, slot);
}

// A group of G consecutive lanes of a warp that walk one ray together
// (G = 1: a lane walks its own ray).  Every lane of a group holds the same
// walk state and takes the same branches, so the group's shuffles and
// ballots name only its own lanes, and groups of a warp may diverge.
template <int G>
struct Group {
  unsigned mask;  // the group's lanes in the warp
  int base;       // its first lane
  int g;          // this lane's index in the group
};

template <int G>
__device__ __forceinline__ Group<G> group_of() {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int base = lane & ~(G - 1);
  return {((1u << G) - 1u) << base, base, lane - base};
}

// A leaf row tested by a group: lane g tests slots g*8/G .. (g+1)*8/G - 1,
// then the group takes the lexicographic minimum of (t, slot) over its
// lanes, which is the hit a strict t < best_t scan in slot order keeps (the
// first slot of the smallest t), and updates (best_t, best_i) if it is
// strictly below best_t.  Occluded mode: any lane's hit t < md.
template <bool kOccluded, int G>
__device__ __forceinline__ bool leaf_row_group(const float4* __restrict__ tr,
                                               const Ray& r, float md,
                                               float& best_t, int& best_i,
                                               const Group<G>& grp) {
  constexpr int K = 8 / G;
  float t = INFINITY;
  int i = 0, s = 8;
  const bool hit =
      leaf_slots<kOccluded, K>(tr, K * grp.g, r, md, kEps, t, i, s);
  if (kOccluded) return __ballot_sync(grp.mask, hit) != 0;
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    const float ot = __shfl_xor_sync(grp.mask, t, off, G);
    const int oi = __shfl_xor_sync(grp.mask, i, off, G);
    const int os = __shfl_xor_sync(grp.mask, s, off, G);
    if (ot < t || (ot == t && os < s)) {
      t = ot;
      i = oi;
      s = os;
    }
  }
  if (t < best_t) {
    best_t = t;
    best_i = i;
  }
  return false;
}

// Intersects the leaf children set in `leaves` (bit s: slot s) in slot
// order, each at its leaf row rows[s], by one lane (G = 1) or by its group;
// returns true at an occluded mode's first hit.  A loop over the set bits,
// so a warp runs as many leaf rows as its busiest lane or group, and one
// copy of the row test serves every slot.
template <bool kOccluded, int kSlots, int G>
__device__ __forceinline__ bool leaf_children(
    unsigned leaves, const int (&rows)[kSlots],
    const float4* __restrict__ tris, const Ray& r, float md, float& best_t,
    int& best_i, const Group<G>& grp) {
  while (leaves) {
    const int s = __ffs(leaves) - 1;
    leaves &= leaves - 1;
    int row = rows[0];
#pragma unroll
    for (int q = 1; q < kSlots; ++q) row = s == q ? rows[q] : row;
    const float4* tr = tris + 32 * static_cast<size_t>(row);
    if constexpr (G == 1) {
      if (leaf_row<kOccluded>(tr, r, md, kEps, best_t, best_i)) return true;
    } else {
      if (leaf_row_group<kOccluded, G>(tr, r, md, best_t, best_i, grp)) {
        return true;
      }
    }
  }
  return false;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        int i) {
  Ray r;
  r.ox = __ldg(origin + 3 * i + 0);
  r.oy = __ldg(origin + 3 * i + 1);
  r.oz = __ldg(origin + 3 * i + 2);
  r.dx = __ldg(direction + 3 * i + 0);
  r.dy = __ldg(direction + 3 * i + 1);
  r.dz = __ldg(direction + 3 * i + 2);
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

__device__ __forceinline__ int octant_of(const Ray& r) {
  return (r.dx >= 0.f ? 4 : 0) + (r.dy >= 0.f ? 2 : 0) + (r.dz >= 0.f ? 1 : 0);
}

// Registers and local bytes per thread, and resident blocks of kBlock
// threads per SM, of a kernel: what each kernel's *_attrs export reports.
inline int func_attrs(const void* fn, int* num_regs, int* local_bytes,
                      int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      kBlock, 0);
  return static_cast<int>(err);
}

}  // namespace dpt

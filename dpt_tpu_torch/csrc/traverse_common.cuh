// Device helpers shared by the BVH walks K1 (quad_traverse.cu) and K2
// (wide_traverse.cu): the slab test and the Möller–Trumbore leaf-row test,
// in the arithmetic order of the TPU kernels and of the plain PyTorch walks
// (dpt_tpu_torch/kernels/quad.py `_slab`, `_leaf_tests`).  Both kernels are
// built with -fmad=false, so these are the same roundings as the plain
// walks and the two agree exactly on the card.
#pragma once

#include <cuda_runtime.h>

namespace dpt {

constexpr int kStack = 64;
constexpr int kBlock = 128;
constexpr float kTMax = 1e30f;
constexpr float kTiny = 1e-20f;
// Möller–Trumbore epsilon hard-coded by both TPU kernels
// (pallas_quad.py:610,627; pallas_wide.py:293,310).
constexpr float kEps = 1e-6f;

// NaN-propagating min / max (torch.minimum / jnp.minimum semantics): a
// NaN-boxed empty slot can never pass the slab test.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
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

// Tests the 8 slots of a leaf row (8 triangles x 16 floats: v0, e1, e2,
// oid, valid) in slot order.  Nearest mode takes strictly smaller t into
// (best_t, best_i); occluded mode returns true at the first hit t < md.
template <bool kOccluded>
__device__ __forceinline__ bool leaf_row(const float4* __restrict__ tr,
                                         const Ray& r, float md,
                                         float& best_t, int& best_i) {
  for (int k = 0; k < 8; ++k) {
    const float4 a = __ldg(tr + 4 * k + 0);  // v0x v0y v0z e1x
    const float4 b = __ldg(tr + 4 * k + 1);  // e1y e1z e2x e2y
    const float4 c = __ldg(tr + 4 * k + 2);  // e2z oid valid -
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
    const bool valid = c.z > 0.5f;

    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool parallel = fabsf(det) < kEps;
    const float inv_det = 1.0f / (parallel ? 1.0f : det);
    const float tx = r.ox - v0x;
    const float ty = r.oy - v0y;
    const float tz = r.oz - v0z;
    const float u = inv_det * (tx * px + ty * py + tz * pz);
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = inv_det * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
    const bool tri_hit = !parallel && u >= 0.f && u <= 1.f && v >= 0.f &&
                         u + v <= 1.f && t > kEps && valid;
    if (kOccluded) {
      if (tri_hit && t < md) return true;
    } else if (tri_hit && t < best_t) {
      best_t = t;
      best_i = static_cast<int>(c.y);
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

}  // namespace dpt

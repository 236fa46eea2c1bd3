// K1 on Hopper: nearest-hit and any-hit walk of the 4-wide BVH.
//
// Replaces dpt_tpu/kernels/pallas_quad.py::_kernel (the Pallas TPU kernel
// launched by _traverse, through quad_nearest and quad_occluded).  The
// tables are the ones pack_quad builds (dpt_tpu_torch/kernels/quad.py):
//   nodes: W records of 32 floats — 4 child AABBs (lanes 0-23), child
//          pointers (24-27: >= 0 a record id, < 0 leaf row -(row+1)),
//          per-octant "left is nearer" masks (28-30).  Empty slots hold
//          NaN boxes.
//   tris:  L leaf rows of 128 floats — 8 triangles x 16 lanes
//          (v0, e1, e2, oid, valid).
//
// Design: one thread per ray, with a per-thread stack of kStack entries in
// local memory (the wrapper checks 3*max_depth+2 <= kStack).  The template
// flag selects nearest or occluded mode.  The kernel computes what the TPU
// kernel computes, but for one ray instead of a tile: the ray's own
// direction octant picks the near child (the TPU kernel votes per tile),
// leaf children are intersected in slot order before any push, internal
// children are pushed far to near, Möller–Trumbore uses the hard-coded
// 1e-6 for the parallel test and for t > eps, and updates take strictly
// smaller t.  Occluded mode returns at its first hit, and at once for
// max_dist <= 0.  min/max propagate NaN, as torch.minimum and jnp.minimum
// do, so an empty slot can never pass the slab test.
//
// What bounds it on this card: each iteration is a chain of dependent
// global loads (pop -> 128-byte record -> 64-byte leaf triangles) through
// the read-only cache, and rays of one warp diverge in their walks.  This
// first version does nothing about either: it is the simple, correct
// version.  It is built with -fmad=false so its arithmetic is the same
// sequence of roundings as the plain PyTorch walk, which makes the two
// comparable exactly on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kStack = 64;
constexpr int kBlock = 128;
constexpr float kTMax = 1e30f;
constexpr float kTiny = 1e-20f;
constexpr float kEps = 1e-6f;

// NaN-propagating min / max (torch.minimum / torch.maximum semantics).
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

template <bool kOccluded>
__global__ void __launch_bounds__(kBlock) quad_traverse_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ max_dist, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, int n_rays, float* __restrict__ out_t,
    int* __restrict__ out_tri) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const float ox = __ldg(origin + 3 * r + 0);
  const float oy = __ldg(origin + 3 * r + 1);
  const float oz = __ldg(origin + 3 * r + 2);
  const float dx = __ldg(direction + 3 * r + 0);
  const float dy = __ldg(direction + 3 * r + 1);
  const float dz = __ldg(direction + 3 * r + 2);
  float md = 0.f;
  if (kOccluded) {
    md = __ldg(max_dist + r);
    if (md <= 0.f) {
      out_tri[r] = 0;
      return;
    }
  }
  const float ix = safe_inv(dx);
  const float iy = safe_inv(dy);
  const float iz = safe_inv(dz);
  const int octant =
      (dx >= 0.f ? 4 : 0) + (dy >= 0.f ? 2 : 0) + (dz >= 0.f ? 1 : 0);

  int stack[kStack];
  int sp = 1;
  stack[0] = 0;
  float best_t = kTMax;
  int best_i = 0;

  while (sp > 0) {
    const int rid = stack[--sp];
    float f[32];
    const float4* rec = nodes + 8 * static_cast<size_t>(rid);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = __ldg(rec + q);
      f[4 * q + 0] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }

    bool hit[4];
    float ptr[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int b = 6 * s;
      float t0 = (f[b + 0] - ox) * ix;
      float t1 = (f[b + 3] - ox) * ix;
      float tn = min_nan(t0, t1);
      float tf = max_nan(t0, t1);
      t0 = (f[b + 1] - oy) * iy;
      t1 = (f[b + 4] - oy) * iy;
      tn = max_nan(tn, min_nan(t0, t1));
      tf = min_nan(tf, max_nan(t0, t1));
      t0 = (f[b + 2] - oz) * iz;
      t1 = (f[b + 5] - oz) * iz;
      tn = max_nan(tn, min_nan(t0, t1));
      tf = min_nan(tf, max_nan(t0, t1));
      hit[s] = kOccluded ? (tn <= tf && tf >= 0.f && tn < md)
                         : (tn <= tf && tf >= 0.f && tn <= best_t);
      ptr[s] = f[24 + s];
    }

    // Leaf children, in slot order, before any push.
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!(hit[s] && ptr[s] < 0.f)) continue;
      const int row = static_cast<int>(-ptr[s] - 1.0f);
      const float4* tr = tris + 32 * static_cast<size_t>(row);
      for (int k = 0; k < 8; ++k) {
        const float4 a = __ldg(tr + 4 * k + 0);  // v0x v0y v0z e1x
        const float4 b = __ldg(tr + 4 * k + 1);  // e1y e1z e2x e2y
        const float4 c = __ldg(tr + 4 * k + 2);  // e2z oid valid -
        const float v0x = a.x, v0y = a.y, v0z = a.z;
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = c.x;
        const bool valid = c.z > 0.5f;

        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool parallel = fabsf(det) < kEps;
        const float inv_det = 1.0f / (parallel ? 1.0f : det);
        const float tx = ox - v0x;
        const float ty = oy - v0y;
        const float tz = oz - v0z;
        const float u = inv_det * (tx * px + ty * py + tz * pz);
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = inv_det * (dx * qx + dy * qy + dz * qz);
        const float t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
        const bool tri_hit = !parallel && u >= 0.f && u <= 1.f && v >= 0.f &&
                             u + v <= 1.f && t > kEps && valid;
        if (kOccluded) {
          if (tri_hit && t < md) {
            out_tri[r] = 1;
            return;
          }
        } else if (tri_hit && t < best_t) {
          best_t = t;
          best_i = static_cast<int>(c.y);
        }
      }
    }

    // Internal children, pushed far to near so the near one pops first.
    if (kOccluded) {
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        if (hit[k] && ptr[k] >= 0.f) stack[sp++] = static_cast<int>(ptr[k]);
      }
    } else {
      const bool near_a = (static_cast<int>(f[28]) >> octant) & 1;
      const bool near_b = (static_cast<int>(f[29]) >> octant) & 1;
      const bool near_c = (static_cast<int>(f[30]) >> octant) & 1;
      const int l_near = near_b ? 0 : 1;
      const int r_near = near_c ? 2 : 3;
      const int l_far = 1 - l_near;
      const int r_far = 5 - r_near;
      const int rank[4] = {near_a ? l_near : r_near, near_a ? l_far : r_far,
                           near_a ? r_near : l_near, near_a ? r_far : l_far};
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const int s = rank[k];
        if (hit[s] && ptr[s] >= 0.f) stack[sp++] = static_cast<int>(ptr[s]);
      }
    }
  }

  if (kOccluded) {
    out_tri[r] = 0;
  } else {
    out_t[r] = best_t;
    out_tri[r] = best_i;
  }
}

}  // namespace

// Launch on `stream`.  Nearest mode writes out_t (min t, 1e30 on a miss)
// and out_tri (triangle id); occluded mode writes out_tri (0/1) only, and
// ignores out_t.  Returns cudaGetLastError() after the launch.
extern "C" int dpt_quad_traverse(const float* origin, const float* direction,
                                 const float* max_dist, const float* nodes,
                                 const float* tris, int n_rays, int occluded,
                                 float* out_t, int* out_tri, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_rays + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (occluded) {
    quad_traverse_kernel<true><<<grid, kBlock, 0, s>>>(
        origin, direction, max_dist, n4, t4, n_rays, out_t, out_tri);
  } else {
    quad_traverse_kernel<false><<<grid, kBlock, 0, s>>>(
        origin, direction, max_dist, n4, t4, n_rays, out_t, out_tri);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (stack + spills) per thread of each mode.
extern "C" int dpt_quad_traverse_attrs(int occluded, int* num_regs,
                                       int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      occluded ? cudaFuncGetAttributes(&attr, quad_traverse_kernel<true>)
               : cudaFuncGetAttributes(&attr, quad_traverse_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

extern "C" const char* dpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// Design: one thread per ray, with a per-thread stack of dpt::kStack entries
// in local memory (the wrapper checks 3*max_depth+2 <= kStack).  The slab
// and leaf-row tests live in traverse_common.cuh, shared with K2.  The
// template flag selects nearest or occluded mode.  The kernel computes what the TPU
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

#include "traverse_common.cuh"

namespace {

using dpt::kBlock;
using dpt::kStack;
using dpt::kTMax;

template <bool kOccluded>
__global__ void __launch_bounds__(kBlock) quad_traverse_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ max_dist, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, int n_rays, float* __restrict__ out_t,
    int* __restrict__ out_tri) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  float md = 0.f;
  if (kOccluded) {
    md = __ldg(max_dist + r);
    if (md <= 0.f) {
      out_tri[r] = 0;
      return;
    }
  }
  const dpt::Ray ray = dpt::load_ray(origin, direction, r);
  const int octant = dpt::octant_of(ray);

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
      float tn, tf;
      dpt::slab(f, 6 * s, ray, tn, tf);
      hit[s] = kOccluded ? (tn <= tf && tf >= 0.f && tn < md)
                         : (tn <= tf && tf >= 0.f && tn <= best_t);
      ptr[s] = f[24 + s];
    }

    // Leaf children, in slot order, before any push.
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!(hit[s] && ptr[s] < 0.f)) continue;
      const int row = static_cast<int>(-ptr[s] - 1.0f);
      if (dpt::leaf_row<kOccluded>(tris + 32 * static_cast<size_t>(row), ray,
                                   md, best_t, best_i)) {
        out_tri[r] = 1;
        return;
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

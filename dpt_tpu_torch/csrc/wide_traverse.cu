// K2 on Hopper: nearest-hit and any-hit walk of the paired-children BVH.
//
// Replaces dpt_tpu/kernels/pallas_wide.py::_kernel (the Pallas TPU kernel
// launched by _traverse, through wide_nearest and wide_occluded;
// traversal="pallas").  The tables are the ones pack_wide builds
// (dpt_tpu_torch/kernels/wide.py):
//   nodes: internal records of 16 floats, 8 to a 128-float row — the left
//          and right child AABBs (lanes 0-5, 6-11), their pointers (12-13:
//          >= 0 an internal record id, < 0 leaf row -(row+1)) and an 8-bit
//          per-octant "left is nearer" mask (14).
//   tris:  L leaf rows of 128 floats — 8 triangles x 16 lanes
//          (v0, e1, e2, oid, valid).
//
// Design: one thread per ray, with a per-thread stack of dpt::kStack
// internal record ids in local memory (the wrapper checks
// max_depth + 2 <= kStack).  Each iteration pops one record (one 64-byte
// fetch) and tests both children's slabs; a leaf child is intersected at
// once (left before right, slots 0..7, strict t < best_t), and internal
// children are pushed far first so the near one pops first.  The ray's own
// octant picks the near bit of lane 14; the TPU kernel instead votes one
// octant per tile, and interleaves P packet walks with an SMEM stack to
// hide Mosaic's load latency, which a warp scheduler does by itself here.
// Nearest culls a child with tn <= best_t; occluded culls with tn < max_dist
// and returns at the first hit, and at once for max_dist <= 0.
//
// What bounds it on this card: as K1, a chain of dependent global loads
// per iteration (pop -> 64-byte record -> 512-byte leaf row) through the
// read-only cache, and divergent walks within a warp.  This first version
// does nothing about either.  It is built with -fmad=false, so its
// arithmetic is the plain PyTorch walk's sequence of roundings and the two
// agree exactly on the card.

#include "traverse_common.cuh"

namespace {

using dpt::kBlock;
using dpt::kStack;
using dpt::kTMax;

template <bool kOccluded>
__global__ void __launch_bounds__(kBlock) wide_traverse_kernel(
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
    float f[16];
    const float4* rec = nodes + 4 * static_cast<size_t>(rid);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(rec + q);
      f[4 * q + 0] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }

    bool hit[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float tn, tf;
      dpt::slab(f, 6 * c, ray, tn, tf);
      hit[c] = kOccluded ? (tn <= tf && tf >= 0.f && tn < md)
                         : (tn <= tf && tf >= 0.f && tn <= best_t);
    }
    const float lptr = f[12];
    const float rptr = f[13];

    // Leaf children at once, left before right.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float ptr = c == 0 ? lptr : rptr;
      if (!(hit[c] && ptr < 0.f)) continue;
      const int row = static_cast<int>(-ptr - 1.0f);
      if (dpt::leaf_row<kOccluded>(tris + 32 * static_cast<size_t>(row), ray,
                                   md, best_t, best_i)) {
        out_tri[r] = 1;
        return;
      }
    }

    // Internal children: far first, so the near one pops first.
    const bool push_l = hit[0] && lptr >= 0.f;
    const bool push_r = hit[1] && rptr >= 0.f;
    const int lid = static_cast<int>(lptr);
    const int rid2 = static_cast<int>(rptr);
    if (push_l && push_r) {
      const bool left_near = (static_cast<int>(f[14]) >> octant) & 1;
      stack[sp++] = left_near ? rid2 : lid;
      stack[sp++] = left_near ? lid : rid2;
    } else if (push_l) {
      stack[sp++] = lid;
    } else if (push_r) {
      stack[sp++] = rid2;
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
extern "C" int dpt_wide_traverse(const float* origin, const float* direction,
                                 const float* max_dist, const float* nodes,
                                 const float* tris, int n_rays, int occluded,
                                 float* out_t, int* out_tri, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_rays + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (occluded) {
    wide_traverse_kernel<true><<<grid, kBlock, 0, s>>>(
        origin, direction, max_dist, n4, t4, n_rays, out_t, out_tri);
  } else {
    wide_traverse_kernel<false><<<grid, kBlock, 0, s>>>(
        origin, direction, max_dist, n4, t4, n_rays, out_t, out_tri);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (stack + spills) per thread of each mode.
extern "C" int dpt_wide_traverse_attrs(int occluded, int* num_regs,
                                       int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      occluded ? cudaFuncGetAttributes(&attr, wide_traverse_kernel<true>)
               : cudaFuncGetAttributes(&attr, wide_traverse_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

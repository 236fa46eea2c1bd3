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
// What each ray computes is the plain walk's, exactly: each visit pops one
// record (one 64-byte fetch) and tests both children's slabs; a leaf child
// is intersected at once (left before right, slots 0..7, strict
// t < best_t), and internal children are pushed far first so the near one
// pops first.  The ray's own octant picks the near bit of lane 14; the TPU
// kernel instead votes one octant per tile, and interleaves P packet walks
// with an SMEM stack to hide Mosaic's load latency.  Nearest culls a child
// with tn <= best_t; occluded culls with tn < max_dist and returns at the
// first hit, and at once for max_dist <= 0.  It is built with -fmad=false,
// so its arithmetic is the plain walk's sequence of roundings.
//
// What bounds it on this card: as K1 (quad_traverse.cu), issued
// instructions and the latency of each visit's dependent loads, not bytes.
// It shares K1's cheaper visit: one-instruction NaN min/max, the leaf rows'
// loads issued a slot ahead, and the near child taken at once instead of
// pushed and popped.  One thread walks one ray, with a per-thread stack of
// dpt::kStack internal record ids (the wrapper checks
// max_depth + 2 <= kStack).  K1's groups of lanes, here two per ray, lost
// to one ray per lane on every stream measured (PERF.md, PR 4).

#include "traverse_common.cuh"

namespace {

using dpt::kBlock;
using dpt::kStack;
using dpt::kTMax;

// One visit of record `node`: tests both children's slabs, intersects the
// leaf children at once, left before right, and sets `node` to the nearer
// hit internal child, pushing the farther, or to the popped top of the
// stack, or to -1 when the walk is over — the order of pushing far then
// near and popping one.  Returns true at an occluded mode's first hit.
template <bool kOccluded>
__device__ __forceinline__ bool wide_visit(const float4* __restrict__ nodes,
                                           const float4* __restrict__ tris,
                                           const dpt::Ray& ray, int octant,
                                           float md, int& node, int* stack,
                                           int& sp, float& best_t,
                                           int& best_i) {
  float f[16];
  const float4* rec = nodes + 4 * static_cast<size_t>(node);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(rec + q);
    f[4 * q + 0] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }

  bool inner[2];
  int ids[2];
  unsigned leaves = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float tn, tf;
    dpt::slab(f, 6 * c, ray, tn, tf);
    const bool hit = kOccluded ? (tn <= tf && tf >= 0.f && tn < md)
                               : (tn <= tf && tf >= 0.f && tn <= best_t);
    const float ptr = f[12 + c];
    inner[c] = hit && ptr >= 0.f;
    ids[c] = inner[c] ? static_cast<int>(ptr) : static_cast<int>(-ptr - 1.0f);
    if (hit && ptr < 0.f) leaves |= 1u << c;
  }

  // Leaf children at once, left before right.
  if (dpt::leaf_children<kOccluded>(leaves, ids, tris, ray, md, best_t,
                                    best_i, dpt::Group<1>{})) {
    return true;
  }
  if (inner[0] && inner[1]) {
    const bool left_near = (static_cast<int>(f[14]) >> octant) & 1;
    stack[sp++] = left_near ? ids[1] : ids[0];
    node = left_near ? ids[0] : ids[1];
  } else if (inner[0] || inner[1]) {
    node = inner[0] ? ids[0] : ids[1];
  } else {
    node = sp > 0 ? stack[--sp] : -1;
  }
  return false;
}

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
  int sp = 0;
  int node = 0;
  float best_t = kTMax;
  int best_i = 0;
  while (node >= 0) {
    if (wide_visit<kOccluded>(nodes, tris, ray, octant, md, node, stack, sp,
                              best_t, best_i)) {
      out_tri[r] = 1;
      return;
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

// Launch on `stream`, with the arguments of dpt_quad_traverse.
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

// Registers and local memory (stack + spills) per thread, and resident
// blocks per SM, of each mode.
extern "C" int dpt_wide_traverse_attrs(int occluded, int* num_regs,
                                       int* local_bytes, int* blocks_per_sm) {
  const void* fn =
      occluded ? reinterpret_cast<const void*>(wide_traverse_kernel<true>)
               : reinterpret_cast<const void*>(wide_traverse_kernel<false>);
  return dpt::func_attrs(fn, num_regs, local_bytes, blocks_per_sm);
}

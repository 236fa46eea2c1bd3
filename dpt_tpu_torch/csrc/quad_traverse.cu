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
// What each ray computes is the plain walk's, exactly: the ray's own
// direction octant picks the near child (the TPU kernel votes per tile),
// leaf children are intersected in slot order before any push, internal
// children are pushed far to near, Möller–Trumbore uses the hard-coded
// 1e-6 for the parallel test and for t > eps, and updates take strictly
// smaller t.  Occluded mode returns at its first hit, and at once for
// max_dist <= 0.  min/max propagate NaN, as torch.minimum and jnp.minimum
// do, so an empty slot can never pass the slab test.  It is built with
// -fmad=false, so its arithmetic is the plain walk's sequence of roundings.
//
// What bounds it on this card: not bytes (the flagship's tables, 6.4 MB,
// sit in the 50 MB L2) but issued instructions and the latency of each
// visit's chain of dependent loads (pop -> 128-byte record -> 512-byte leaf
// row).  The design cuts instructions per visit: one-instruction NaN
// min/max, the leaf rows' loads issued a slot ahead, the visit order kept
// by selects (no runtime-indexed arrays: the stack is the kernel's only
// local memory), and the nearest internal child taken at once instead of
// pushed and popped.  Two layouts of the walk: one ray per lane, with a
// per-lane stack of dpt::kStack entries (the wrapper checks
// 3*max_depth+2 <= kStack); and one ray per group of four lanes, for
// streams of at most GROUP_MAX_RAYS rays (kernels/quad.py; the render's
// queries after the primary), where one ray per lane leaves the card part
// idle and a launch lasts as long as its longest walk: lane g tests child
// g's slab and slots 2g, 2g+1 of each leaf row, so a visit's latency is a
// quarter of a lane's.  The group agrees on every branch (ballots and shuffles among
// its four lanes) and keeps the walk state, stack included, in each lane.
// Refilling a lane from a counter when its walk ends was tried and lost
// (PERF.md, PR 4).

#include "traverse_common.cuh"

namespace {

using dpt::kBlock;
using dpt::kStack;
using dpt::kTMax;

// The rest of a visit once the leaf children are done: orders the hit
// internal children near to far (occluded mode: slot order) by selects from
// the octant's near bits (record lanes 28-30), pushes all but the nearest
// far to near, and sets `node` to the nearest, or to the popped top of the
// stack, or to -1 when the walk is over — the order of pushing all four and
// popping one.
template <bool kOccluded>
__device__ __forceinline__ void quad_descend(const bool (&inner)[4],
                                             const int (&ids)[4], float m0,
                                             float m1, float m2, int octant,
                                             int& node, int* stack, int& sp) {
  bool p[4];
  int c[4];
  if (kOccluded) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      p[s] = inner[s];
      c[s] = ids[s];
    }
  } else {
    const bool na = (static_cast<int>(m0) >> octant) & 1;
    const bool nb = (static_cast<int>(m1) >> octant) & 1;
    const bool nc = (static_cast<int>(m2) >> octant) & 1;
    const bool pl0 = nb ? inner[0] : inner[1], pl1 = nb ? inner[1] : inner[0];
    const int cl0 = nb ? ids[0] : ids[1], cl1 = nb ? ids[1] : ids[0];
    const bool pr0 = nc ? inner[2] : inner[3], pr1 = nc ? inner[3] : inner[2];
    const int cr0 = nc ? ids[2] : ids[3], cr1 = nc ? ids[3] : ids[2];
    p[0] = na ? pl0 : pr0;
    c[0] = na ? cl0 : cr0;
    p[1] = na ? pl1 : pr1;
    c[1] = na ? cl1 : cr1;
    p[2] = na ? pr0 : pl0;
    c[2] = na ? cr0 : cl0;
    p[3] = na ? pr1 : pl1;
    c[3] = na ? cr1 : cl1;
  }
  int next = -1;
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    if (p[k]) {
      if (next >= 0) stack[sp++] = next;
      next = c[k];
    }
  }
  node = next >= 0 ? next : (sp > 0 ? stack[--sp] : -1);
}

// One visit of record `node` by one lane (G = 1: all four slabs) or by a
// group of four (lane g: slab g), then the leaf children in slot order and
// quad_descend.  Returns true at an occluded mode's first hit.
template <bool kOccluded, int G>
__device__ __forceinline__ bool quad_visit(const float4* __restrict__ nodes,
                                           const float4* __restrict__ tris,
                                           const dpt::Ray& ray, int octant,
                                           float md, int& node, int* stack,
                                           int& sp, float& best_t,
                                           int& best_i,
                                           const dpt::Group<G>& grp) {
  const float4* rec = nodes + 8 * static_cast<size_t>(node);
  bool inner[4];
  int ids[4];
  unsigned leaves = 0;
  float m[3] = {0.f, 0.f, 0.f};  // near masks (nearest mode)
  if constexpr (G == 1) {
    float f[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = __ldg(rec + q);
      f[4 * q + 0] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float tn, tf;
      dpt::slab(f, 6 * s, ray, tn, tf);
      const bool hit = kOccluded ? (tn <= tf && tf >= 0.f && tn < md)
                                 : (tn <= tf && tf >= 0.f && tn <= best_t);
      const float ptr = f[24 + s];
      inner[s] = hit && ptr >= 0.f;
      ids[s] = inner[s] ? static_cast<int>(ptr)
                        : static_cast<int>(-ptr - 1.0f);
      if (hit && ptr < 0.f) leaves |= 1u << s;
    }
    m[0] = f[28];
    m[1] = f[29];
    m[2] = f[30];
  } else {
    static_assert(G == 4, "a group of four lanes walks the 4-wide BVH");
    const float* recf = reinterpret_cast<const float*>(rec);
    const float2* bx = reinterpret_cast<const float2*>(recf + 6 * grp.g);
    const float2 b0 = __ldg(bx), b1 = __ldg(bx + 1), b2 = __ldg(bx + 2);
    const float box[6] = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
    const float ptr = __ldg(recf + 24 + grp.g);
    float tn, tf;
    dpt::slab(box, 0, ray, tn, tf);
    const bool hit = kOccluded ? (tn <= tf && tf >= 0.f && tn < md)
                               : (tn <= tf && tf >= 0.f && tn <= best_t);
    const bool in = hit && ptr >= 0.f;
    const int id = in ? static_cast<int>(ptr) : static_cast<int>(-ptr - 1.0f);
    const unsigned in_bits = __ballot_sync(grp.mask, in) >> grp.base;
    leaves = __ballot_sync(grp.mask, hit && ptr < 0.f) >> grp.base;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      inner[s] = (in_bits >> s) & 1;
      ids[s] = __shfl_sync(grp.mask, id, s, G);
    }
    if (!kOccluded) {
      const float4 mk = __ldg(rec + 7);
      m[0] = mk.x;
      m[1] = mk.y;
      m[2] = mk.z;
    }
  }

  // Leaf children, in slot order, before any push.
  if (dpt::leaf_children<kOccluded>(leaves, ids, tris, ray, md, best_t,
                                    best_i, grp)) {
    return true;
  }
  quad_descend<kOccluded>(inner, ids, m[0], m[1], m[2], octant, node, stack,
                          sp);
  return false;
}

// The walk of ray (global thread) / G, by one lane or by a group of G = 4
// lanes; the group's first lane writes the results.
template <bool kOccluded, int G>
__global__ void __launch_bounds__(kBlock) quad_traverse_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ max_dist, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, int n_rays, float* __restrict__ out_t,
    int* __restrict__ out_tri) {
  const dpt::Group<G> grp = dpt::group_of<G>();
  const int r = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G);
  if (r >= n_rays) return;
  const bool writer = grp.g == 0;

  float md = 0.f;
  if (kOccluded) {
    md = __ldg(max_dist + r);
    if (md <= 0.f) {
      if (writer) out_tri[r] = 0;
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
    if (quad_visit<kOccluded, G>(nodes, tris, ray, octant, md, node, stack,
                                 sp, best_t, best_i, grp)) {
      if (writer) out_tri[r] = 1;
      return;
    }
  }
  if (!writer) return;
  if (kOccluded) {
    out_tri[r] = 0;
  } else {
    out_t[r] = best_t;
    out_tri[r] = best_i;
  }
}

template <int G>
int launch(const float* origin, const float* direction, const float* max_dist,
           const float* nodes, const float* tris, int n_rays, int occluded,
           float* out_t, int* out_tri, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(n_rays) * G + kBlock - 1) / kBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (occluded) {
    quad_traverse_kernel<true, G><<<grid, kBlock, 0, s>>>(
        origin, direction, max_dist, n4, t4, n_rays, out_t, out_tri);
  } else {
    quad_traverse_kernel<false, G><<<grid, kBlock, 0, s>>>(
        origin, direction, max_dist, n4, t4, n_rays, out_t, out_tri);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int attrs(int occluded, int* num_regs, int* local_bytes, int* blocks_per_sm) {
  const void* fn =
      occluded ? reinterpret_cast<const void*>(quad_traverse_kernel<true, G>)
               : reinterpret_cast<const void*>(quad_traverse_kernel<false, G>);
  return dpt::func_attrs(fn, num_regs, local_bytes, blocks_per_sm);
}

}  // namespace

// Launch on `stream`, one ray per lane.  Nearest mode writes out_t (min t,
// 1e30 on a miss) and out_tri (triangle id, 0 on a miss), and reads no
// max_dist; occluded mode reads max_dist and writes out_tri (0/1) only.
// Returns cudaGetLastError() after the launch.
extern "C" int dpt_quad_traverse(const float* origin, const float* direction,
                                 const float* max_dist, const float* nodes,
                                 const float* tris, int n_rays, int occluded,
                                 float* out_t, int* out_tri, void* stream) {
  return launch<1>(origin, direction, max_dist, nodes, tris, n_rays, occluded,
                   out_t, out_tri, stream);
}

// The same, one ray per group of four lanes.
extern "C" int dpt_quad_traverse_group(const float* origin,
                                       const float* direction,
                                       const float* max_dist,
                                       const float* nodes, const float* tris,
                                       int n_rays, int occluded, float* out_t,
                                       int* out_tri, void* stream) {
  return launch<4>(origin, direction, max_dist, nodes, tris, n_rays, occluded,
                   out_t, out_tri, stream);
}

// Registers and local memory (stack + spills) per thread, and resident
// blocks per SM, of each mode, one ray per lane and per group.
extern "C" int dpt_quad_traverse_attrs(int occluded, int* num_regs,
                                       int* local_bytes, int* blocks_per_sm) {
  return attrs<1>(occluded, num_regs, local_bytes, blocks_per_sm);
}

extern "C" int dpt_quad_traverse_group_attrs(int occluded, int* num_regs,
                                             int* local_bytes,
                                             int* blocks_per_sm) {
  return attrs<4>(occluded, num_regs, local_bytes, blocks_per_sm);
}

extern "C" const char* dpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3 on Hopper: brute-force nearest hit of each ray over every triangle.
//
// Replaces dpt_tpu/kernels/pallas_intersect.py::_kernel (the Pallas TPU
// kernel launched by _run, through pallas_nearest; traversal="brute" with
// kernels="intersect").  The table is the one pack_tris builds
// (dpt_tpu_torch/kernels/intersect.py): ceil(T/8) rows of 128 floats, 8
// triangles x 16 lanes (v0, e1 = v1 - v0, e2 = v2 - v0, oid, valid); padded
// slots have valid = 0 and never hit.
//
// Design: one thread per ray, blocks of dpt::kBlock.  Each thread runs the
// BVH walks' leaf-row test (traverse_common.cuh `leaf_row`, nearest mode)
// over every row of the table in order, with the caller's eps, so the
// update is the TPU kernel's strict t < best_t in slot order: ties go to
// the lowest triangle id, best_t starts at 1e30 and best_i at 0, which is
// what a miss returns.  The TPU kernel instead keeps a 1024-ray tile and
// the whole table in VMEM; here the table stays in global memory, and all
// threads of a warp read the same triangle at the same time, so each load
// is one broadcast through the read-only cache, and a table of any size
// works.
//
// What bounds it on this card: operations — 54 float operations per
// triangle test against 24 + 8 bytes of rays per ray and the table read
// once.  This first version does nothing beyond the broadcast loads (no
// shared-memory tiles of triangles).  It is built with -fmad=false, so its
// arithmetic is the plain PyTorch version's sequence of roundings and the
// two agree exactly on the card.

#include "traverse_common.cuh"

namespace {

using dpt::kBlock;
using dpt::kTMax;

__global__ void __launch_bounds__(kBlock) intersect_nearest_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float4* __restrict__ tris, int n_rays, int n_rows, float eps,
    float* __restrict__ out_t, int* __restrict__ out_tri) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const dpt::Ray ray = dpt::load_ray(origin, direction, r);
  float best_t = kTMax;
  int best_i = 0;
  for (int row = 0; row < n_rows; ++row) {
    dpt::leaf_row<false>(tris + 32 * static_cast<size_t>(row), ray, 0.f, eps,
                         best_t, best_i);
  }
  out_t[r] = best_t;
  out_tri[r] = best_i;
}

}  // namespace

// Launch on `stream`: out_t gets the nearest t (1e30 on a miss), out_tri the
// triangle id (0 on a miss).  Returns cudaGetLastError() after the launch.
extern "C" int dpt_intersect_nearest(const float* origin,
                                     const float* direction,
                                     const float* tris, int n_rays,
                                     int n_rows, float eps, float* out_t,
                                     int* out_tri, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_rays + kBlock - 1) / kBlock);
  intersect_nearest_kernel<<<grid, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      origin, direction, reinterpret_cast<const float4*>(tris), n_rays,
      n_rows, eps, out_t, out_tri);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory per thread, and resident blocks per SM.  The
// kernel has one mode, nearest: `occluded` must be 0 (the walks' attribute
// functions take the same arguments).
extern "C" int dpt_intersect_nearest_attrs(int occluded, int* num_regs,
                                           int* local_bytes,
                                           int* blocks_per_sm) {
  if (occluded) return static_cast<int>(cudaErrorInvalidValue);
  return dpt::func_attrs(
      reinterpret_cast<const void*>(intersect_nearest_kernel), num_regs,
      local_bytes, blocks_per_sm);
}

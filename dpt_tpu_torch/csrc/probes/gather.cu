// P3 on Hopper: an in-tile dynamic gather, repeated, in one block.
//
// Replaces the two Pallas kernels of scripts/attic/probe_gather.py
// `pallas_gather_probe` :64, which priced Mosaic's dynamic_gather:
//   P3-a `kern` :66 (pallas_call :82), x f32 [8, 128], idx i32 [8, 128]:
//        acc[r, c] += x[r, (idx[r, c] + k) % 128]   for k < iters (1000)
//   P3-b `kern0` :98 (pallas_call :113), x f32 [64, 128], idx i32 [64, 128]:
//        acc[r, c] += x[(idx[r, c] + k) % 64, c]    for k < iters (100)
// % is jnp's floor mod; by a power of two it is the low bits of the
// two's-complement sum, which is how the kernels take it (any int32 index,
// the sum wrapping as in int32).
//
// Design: a lookup crosses the 128 lanes of a row (P3-a) or the 64 rows of
// a column (P3-b), which is four warps or more, beyond a warp shuffle's
// reach, so the tile lives in shared memory: 4 KB for P3-a, 32 KB for P3-b.
// One block of 1024 threads; P3-a one element a thread, P3-b eight (rows
// r, r + 8, ..., the same column), each with its index in a register and
// its sum kept in the order of k.  What bounds it: one SM runs the block,
// and each step is one shared-memory word per element (32 words a clock
// per SM) and two integer operations for the index (64 a clock per SM),
// so about 32 clocks a step for 1024 elements; the card's other SMs idle
// by construction.

#include "probe_common.cuh"

namespace {

using dpt::probe::kTile;
constexpr int kLanes = 128;
constexpr int kRows0 = 64;  // P3-b's rows
constexpr int kPerThread0 = kRows0 * kLanes / kTile;

__global__ void __launch_bounds__(kTile) gather_axis1_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, int iters,
    float* __restrict__ out) {
  __shared__ float xs[kTile];
  const int e = static_cast<int>(threadIdx.x);
  xs[e] = __ldg(x + e);
  const unsigned j0 = static_cast<unsigned>(__ldg(idx + e));
  const int row = e - e % kLanes;
  __syncthreads();
  float acc = 0.f;
  for (int k = 0; k < iters; ++k) {
    acc = acc + xs[row + static_cast<int>((j0 + k) & (kLanes - 1))];
  }
  out[e] = acc;
}

__global__ void __launch_bounds__(kTile) gather_axis0_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, int iters,
    float* __restrict__ out) {
  __shared__ float xs[kRows0 * kLanes];
  const int t = static_cast<int>(threadIdx.x);
  const int c = t % kLanes;
  unsigned j0[kPerThread0];
  float acc[kPerThread0];
#pragma unroll
  for (int q = 0; q < kPerThread0; ++q) {
    const int e = t + q * kTile;
    xs[e] = __ldg(x + e);
    j0[q] = static_cast<unsigned>(__ldg(idx + e));
    acc[q] = 0.f;
  }
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int q = 0; q < kPerThread0; ++q) {
      const int r = static_cast<int>((j0[q] + k) & (kRows0 - 1));
      acc[q] = acc[q] + xs[r * kLanes + c];
    }
  }
#pragma unroll
  for (int q = 0; q < kPerThread0; ++q) out[t + q * kTile] = acc[q];
}

}  // namespace

// One launch on `stream`: x f32 and idx int32 of P3-a's [8, 128] or P3-b's
// [64, 128] tile, out f32 of the same shape, `iters` steps.  Returns
// cudaGetLastError() after the launch.
extern "C" int dpt_probe_gather_axis1(const float* x, const int* idx,
                                      int iters, float* out, void* stream) {
  gather_axis1_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, iters, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpt_probe_gather_axis0(const float* x, const int* idx,
                                      int iters, float* out, void* stream) {
  gather_axis0_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, iters, out);
  return static_cast<int>(cudaGetLastError());
}

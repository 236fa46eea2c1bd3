// P4 on Hopper: the per-lane lookup primitives of scripts/probe_crossbar.py,
// each a loop over one [8, 128] tile: A-D in one block, E over 32 SMs.
//
// Replaces the five Pallas kernels of scripts/probe_crossbar.py, run by
// `run_kernel` :30 (pallas_call :33) or `go_d` :109 (pallas_call :110),
// ITERS = 2000 steps, acc from 0 and every sum in the order of k:
//   P4-a `kern_a` :48  acc[r, c] += x[(sub[r, c] + k) % 8, c]
//   P4-b `kern_b` :64  for k < ITERS // K, for q = 0..K-1 in order:
//                      acc[r, c] += (x + q)[r, (idx[r, c] + k) % 128]
//                      (K = 1, 4, 12: K independent lane gathers a step)
//   P4-c `kern_c` :80  s = (srow[r, c] + k) % 8;
//                      acc[r, c] += x[s, (lane[s, c] + k) % 128]
//                      (a lane gather then a sublane gather, fused)
//   P4-d `kern_d` :101 acc[r, c] += tab[rows[k] * 8 + r, c], tab f32
//                      [4096, 128] (2 MB), rows int32 [ITERS]
//   P4-e `kern_e` :127 v = x + acc; 70 times v = v * 1.0001 + 0.5; acc = v
// % is jnp's floor mod, taken as the low bits of the two's-complement sum.
// P4-d's row block starts where JAX's `pl.ds(rows[k] * 8, 8)` does
// (`dyn_start`).
//
// Design: A-D in one block of 1024 threads, one thread per tile element;
// E in 32 blocks of one warp (below).  A-C look
// across four warps' lanes or across rows, beyond a warp shuffle, so x
// (and C's lane table) live in shared memory.  B keeps its K tiles x + q in
// shared memory (K x 4 KB, dynamic), so its K lookups a step are K loads
// from K tiles, as the TPU probe's are, and not one load that the compiler
// would share.  C reads x and lane at row s directly: the same values as
// the TPU probe's g1 at (s, c), with no barrier.  D's table (2 MB) does not
// fit in shared memory (227 KB at most): it stays in device memory and L2,
// so each step is a 4 KB row block from L2 (one 512-byte row per warp
// group), not the TPU's VMEM; rows are staged in shared memory 1,024 at a
// time, and the step loop is unrolled by 8 (eight row blocks' loads in
// flight, their adds in the order of k), so steps overlap (on an H100 this
// form takes 42 ns a step where a broadcast load of rows[k] in each
// unrolled step takes 76: probes/rows_ablation.py).  E keeps v in a
// register: 141 dependent operations a step per element.  -fmad=false and
// float literals (1.0001f, 0.5f) keep each multiply and add rounded apart,
// as the plain version's; XLA contracts E's chain, so E is held to the JAX
// probe within a rounding, and to the plain version bit for bit.  What
// bounds them: one SM runs the block of A-D.  A-C need one or two
// shared-memory words per lookup per element (32 words a clock per SM) and
// two integer operations for each index (64 a clock per SM); D 4 KB a step
// from L2.  E in one block (the first port) was bound by its SM's issue
// of 1024 x 141 float operations a step (128 a clock: about 1,128 clocks a
// step); spread as 32 blocks of one warp, one warp an SM, no SM's issue
// binds and the chain's latency does: 141 dependent operations of ~4
// clocks a step (probes/__init__.py latency_bound_ms).  The clocks a
// dependent operation of that bound are the card's, read apart from E's
// code by a bare chain of multiplies and adds (op_chain_kernel,
// dpt_probe_crossbar_op_cycles); E's own clocks an operation
// (dpt_probe_crossbar_math_cycles) are printed beside them.

#include "probe_common.cuh"

namespace {

using dpt::probe::dyn_start;
using dpt::probe::kTile;
constexpr int kLanes = 128;
constexpr int kRows = 8;
constexpr int kUnroll = 8;     // P4-d's steps in flight
constexpr int kRowChunk = 1024;  // P4-d's rows staged at a time
constexpr int kMathOps = 70;   // P4-e's multiply-adds a step
constexpr int kMathThreads = 32;  // P4-e's threads a block: one warp
constexpr int kChainPairs = 512;  // the bare chain's multiply-adds a step

__global__ void __launch_bounds__(kTile) sublane_kernel(
    const float* __restrict__ x, const int* __restrict__ sub, int iters,
    float* __restrict__ out) {
  __shared__ float xs[kTile];
  const int e = static_cast<int>(threadIdx.x);
  const int c = e % kLanes;
  xs[e] = __ldg(x + e);
  const unsigned s0 = static_cast<unsigned>(__ldg(sub + e));
  __syncthreads();
  float acc = 0.f;
  for (int k = 0; k < iters; ++k) {
    acc = acc + xs[static_cast<int>((s0 + k) & (kRows - 1)) * kLanes + c];
  }
  out[e] = acc;
}

template <int K>
__global__ void __launch_bounds__(kTile) lanes_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, int iters,
    float* __restrict__ out) {
  extern __shared__ float xq[];  // [K][1024]: x + q
  const int e = static_cast<int>(threadIdx.x);
  const float xe = __ldg(x + e);
#pragma unroll
  for (int q = 0; q < K; ++q) xq[q * kTile + e] = xe + static_cast<float>(q);
  const unsigned j0 = static_cast<unsigned>(__ldg(idx + e));
  const int row = e - e % kLanes;
  __syncthreads();
  float acc = 0.f;
  for (int k = 0; k < iters; ++k) {
    const int j = row + static_cast<int>((j0 + k) & (kLanes - 1));
#pragma unroll
    for (int q = 0; q < K; ++q) acc = acc + xq[q * kTile + j];
  }
  out[e] = acc;
}

__global__ void __launch_bounds__(kTile) fused_kernel(
    const float* __restrict__ x, const int* __restrict__ lane,
    const int* __restrict__ srow, int iters, float* __restrict__ out) {
  __shared__ float xs[kTile];
  __shared__ unsigned ls[kTile];
  const int e = static_cast<int>(threadIdx.x);
  const int c = e % kLanes;
  xs[e] = __ldg(x + e);
  ls[e] = static_cast<unsigned>(__ldg(lane + e));
  const unsigned s0 = static_cast<unsigned>(__ldg(srow + e));
  __syncthreads();
  float acc = 0.f;
  for (int k = 0; k < iters; ++k) {
    const int s = static_cast<int>((s0 + k) & (kRows - 1)) * kLanes;
    const int j = static_cast<int>((ls[s + c] + k) & (kLanes - 1));
    acc = acc + xs[s + j];
  }
  out[e] = acc;
}

__global__ void __launch_bounds__(kTile) rows_kernel(
    const float* __restrict__ tab, int n_rows, const int* __restrict__ rows,
    int iters, float* __restrict__ out) {
  __shared__ int start[kRowChunk];  // element offset of each step's block
  const int e = static_cast<int>(threadIdx.x);
  float acc = 0.f;
  for (int k0 = 0; k0 < iters; k0 += kRowChunk) {
    const int n = min(kRowChunk, iters - k0);
    __syncthreads();
    for (int j = e; j < n; j += kTile) {
      // rows[k] * 8 wraps in int32, as in JAX
      const int r8 = static_cast<int>(
          static_cast<unsigned>(__ldg(rows + k0 + j)) * kRows);
      start[j] = dyn_start(r8, n_rows, kRows) * kLanes;
    }
    __syncthreads();
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(tab + start[j + u] + e);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = acc + v[u];
    }
    for (; j < n; ++j) acc = acc + __ldg(tab + start[j] + e);
  }
  out[e] = acc;
}

// Element blockIdx.x * 32 + threadIdx.x; with `cycles`, thread 0 writes
// the SM clocks from before the loop to after its store of out.
__global__ void __launch_bounds__(kMathThreads) math_kernel(
    const float* __restrict__ x, int iters, float* __restrict__ out,
    long long* __restrict__ cycles) {
  const int e = static_cast<int>(blockIdx.x * kMathThreads + threadIdx.x);
  const float xe = __ldg(x + e);
  const long long start = clock64();
  float acc = 0.f;
  for (int k = 0; k < iters; ++k) {
    float v = xe + acc;
#pragma unroll
    for (int m = 0; m < kMathOps; ++m) v = v * 1.0001f + 0.5f;
    acc = v;
  }
  out[e] = acc;
  if (cycles != nullptr && e == 0) {
    long long end;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(end)::"memory");
    *cycles = end - start;
  }
}

// The card's clocks a dependent float operation, apart from E's code: one
// warp, each lane a chain of `iters` steps of kChainPairs x (multiply,
// add), E's constants rounded apart, unrolled so that the loop's own
// instructions are a few in 1,024 (at 64 pairs a step the chain read 4.07
// clocks an operation, above E's own 4.05).  Lane 0 writes the SM
// clocks from before the loop to after its store of out.
__global__ void __launch_bounds__(kMathThreads) op_chain_kernel(
    const float* __restrict__ x, int iters, float* __restrict__ out,
    long long* __restrict__ cycles) {
  const int e = static_cast<int>(threadIdx.x);
  float v = __ldg(x + e);
  const long long start = clock64();
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int m = 0; m < kChainPairs; ++m) v = v * 1.0001f + 0.5f;
  }
  out[e] = v;
  if (e == 0) {
    long long end;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(end)::"memory");
    *cycles = end - start;
  }
}

template <int K>
int launch_lanes(const float* x, const int* idx, int iters, float* out,
                 cudaStream_t s) {
  lanes_kernel<K><<<1, kTile, K * kTile * sizeof(float), s>>>(x, idx, iters,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launch runs on `stream` and returns cudaGetLastError() after it.
// Tiles are [8, 128] (x f32; sub, idx, lane, srow int32), out f32 [8, 128].
extern "C" int dpt_probe_crossbar_sublane(const float* x, const int* sub,
                                          int iters, float* out,
                                          void* stream) {
  sublane_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, sub, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// P4-b: `iters` steps (the TPU probe's ITERS // K) of K lookups; K is 1, 4
// or 12 (the TPU probe's), another K returns cudaErrorInvalidValue.
extern "C" int dpt_probe_crossbar_lanes(const float* x, const int* idx,
                                        int K, int iters, float* out,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_lanes<1>(x, idx, iters, out, s);
    case 4: return launch_lanes<4>(x, idx, iters, out, s);
    case 12: return launch_lanes<12>(x, idx, iters, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dpt_probe_crossbar_fused(const float* x, const int* lane,
                                        const int* srow, int iters,
                                        float* out, void* stream) {
  fused_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, lane, srow, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// P4-d: tab f32 [n_rows, 128] (n_rows >= 8), rows int32 [iters].
extern "C" int dpt_probe_crossbar_rows(const float* tab, int n_rows,
                                       const int* rows, int iters,
                                       float* out, void* stream) {
  rows_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, n_rows, rows, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// P4-e: the tile's 1024 chains in 32 blocks of one warp.
extern "C" int dpt_probe_crossbar_math(const float* x, int iters, float* out,
                                       void* stream) {
  math_kernel<<<kTile / kMathThreads, kMathThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, iters, out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// P4-e's first warp alone (one block, elements 0-31 of out), and the SM
// clocks its chains took from before the loop to after their store
// (cycles: one int64).
extern "C" int dpt_probe_crossbar_math_cycles(const float* x, int iters,
                                              float* out, long long* cycles,
                                              void* stream) {
  math_kernel<<<1, kMathThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, iters, out, cycles);
  return static_cast<int>(cudaGetLastError());
}

// The bare chain (op_chain_kernel) in one warp: out f32 [32], the chains'
// ends; cycles one int64.
extern "C" int dpt_probe_crossbar_op_cycles(const float* x, int iters,
                                            float* out, long long* cycles,
                                            void* stream) {
  op_chain_kernel<<<1, kMathThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, iters, out, cycles);
  return static_cast<int>(cudaGetLastError());
}

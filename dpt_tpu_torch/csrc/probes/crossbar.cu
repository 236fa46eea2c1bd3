// P4 on Hopper: the per-lane lookup primitives of scripts/probe_crossbar.py,
// each a loop over one [8, 128] tile: A and D in one block, B over 8 SMs,
// C and E over 32.
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
// % is jnp's floor mod, taken as the low bits of the two's-complement sum
// (unsigned 32-bit arithmetic masked to the low bits: any int32 index gives
// JAX's answer).  P4-d's row block starts where JAX's `pl.ds(rows[k] * 8,
// 8)` does (`dyn_start`).
//
// Design: A and D in one block of 1024 threads, one thread per tile
// element; B in 8 blocks of 128, C and E in 32 blocks of one warp
// (below).  A looks across
// rows, beyond a warp shuffle, so x lives in shared memory.  D's table
// (2 MB) does not fit in shared memory (227 KB at most): it stays in device
// memory and L2, so each step is a 4 KB row block from L2 (one 512-byte row
// per warp group), not the TPU's VMEM; rows are staged in shared memory
// 1,024 at a time, and the step loop is unrolled by 8 (eight row blocks'
// loads in flight, their adds in the order of k), so steps overlap (on an
// H100 this form takes 42 ns a step where a broadcast load of rows[k] in
// each unrolled step takes 76: probes/rows_ablation.py).  E keeps v in a
// register: 141 dependent operations a step per element.  -fmad=false and
// float literals (1.0001f, 0.5f) keep each multiply and add rounded apart,
// as the plain version's; XLA contracts E's chain, so E is held to the JAX
// probe within a rounding, and to the plain version bit for bit.
//
// B and C, the lane lookups (`lanes_kernel`, `fused_kernel`).  The first port
// ran each in one block of 1024 threads: one SM's shared-memory pipe served
// all 32 warps, and a lookup's index is data, so a warp's 32 lanes fell on
// banks at random (C: ~3.7 wavefronts a warp-step for x beside the one of its
// lane table) or, in B, on at most 4 words a bank of their row (~2.85 a
// warp-gather).  Now the tile is spread over SMs and each warp reads a table
// copied once a bank: word w of lane l's copy lies at w * 32 + l, always bank
// l, so every lookup is one wavefront whatever the indices, as the TPU's
// dynamic_gather costs the same whatever they are.  A swizzle cannot do that:
// it permutes words over banks by their address, and the addresses a warp
// reads are data.  C runs in 32 blocks of one warp, each copying all of x (1024
// words x 32 = 128 KB of dynamic shared memory) and keeping its 32 columns of
// the lane table plain (lane l reads row s at s * 32 + l, bank l already).  B
// reads only its row, so it runs in 8 blocks of 128 threads, a tile row each,
// whose 4 warps share the copies of that row in each of its K tiles x + q (128
// words x 32 x K: 192 KB at K = 12); one-warp blocks would fill each row's
// copies 4 times over.  The copies are filled with 16-byte stores, each warp
// store 512 bytes over all 32 banks (4 wavefronts, the least), then one
// barrier.  B keeps the TPU probe's K lookups from K tiles x + q: K shared
// loads a step, not one load plus q.  C keeps its two lookups a step: the lane
// table's row s is read by a volatile load, since (s0 + k) & 7 has period 8
// and the unroll by 8 makes its 8 addresses per-lane constants the compiler
// would otherwise hoist into registers.  The lookups do not depend on acc, so
// both run one step loop (`sum_steps`) that keeps a group of steps' lookups in
// flight: each lookup of the next group is issued beside an add of this one
// (C ran 5% slower with the group's loads all issued before its adds); each
// kernel gives it only its lookup.  B's group of U steps reads from one base at offsets
// fixed at compile time: its row's copies end with the row's first U - 1 words
// again, so the group's steps need no index arithmetic of their own.  What
// bounds them now: each element's sum, a chain of dependent adds in the order
// of k (2,000 for C, 166 x 12 for B at K = 12), or a warp's issue of a step's
// instructions at one a clock (C: two loads, the index's add, mask and shift,
// and the add), whichever is longer; beside it the fill and the launch.  On an
// H100 (700 W) B's loops take 1.3-1.6 times their chain, C's ~1.25 times
// its issue, and a launch at 0 steps (the fill) 5.5-7.8 us against an empty
// kernel's ~5.3 (scripts/torch_crossbar_shapes.py).  Each kernel has one grid,
// B 8 blocks of 128 and C 32 blocks of 32, fixed in its entry point.
//
// What bounds A and D: one SM runs the block.  A needs one shared-memory
// word per lookup per element (32 words a clock per SM) and two integer
// operations for each index (64 a clock per SM); D 4 KB a step from L2.  E
// in one block (the first port) was bound by its SM's issue of 1024 x 141
// float operations a step (128 a clock: about 1,128 clocks a step); spread
// as 32 blocks of one warp, one warp an SM, no SM's issue binds and the
// chain's latency does: 141 dependent operations of ~4 clocks a step
// (probes/__init__.py latency_bound_ms).  The clocks a dependent operation
// of that bound are the card's, read apart from E's code by a bare chain
// of multiplies and adds (op_chain_kernel, dpt_probe_crossbar_op_cycles);
// E's own clocks an operation (dpt_probe_crossbar_math_cycles) are printed
// beside them.

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
constexpr int kBanks = 32;  // shared-memory banks: a lookup table's copies
constexpr int kLanesThreads = 128;  // B's threads a block: one tile row
constexpr int kGroupLoads = 32;  // B's lookups a group: 32 / K steps
constexpr int kFusedThreads = 32;  // C's threads a block: one warp
constexpr int kFusedGroup = 8;  // C's steps a group, a multiple of 8

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

// Copies kWords words, word w being src[w % kSrc], each plus q for q < K,
// once a bank: word w of tile q at dst[(q * kWords + w) * 8 + m], m < 8,
// each float4 four copies, so lane l reads its copy at float (q * kWords +
// w) * 32 + l.  A thread takes words t, t + kThreads, ...: it loads all of
// them first (their latencies overlap), then stores each word's 8 float4
// in a rotated order ((t + n) & 7): a warp's store, 32 words' float4, puts
// 4 threads on each 16-byte bank quad, 512 bytes in 4 wavefronts, the
// least.
template <int K, int kThreads, int kWords, int kSrc>
__device__ __forceinline__ void fill_copies(float4* __restrict__ dst,
                                            const float* __restrict__ src) {
  constexpr int kPer = (kWords + kThreads - 1) / kThreads;
  const int t = static_cast<int>(threadIdx.x);
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int w = t + i * kThreads;
    if (w < kWords) v[i] = __ldg(src + w % kSrc);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int w = t + i * kThreads;
    if (w >= kWords) break;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const float vq = v[i] + static_cast<float>(q);
      const float4 c = make_float4(vq, vq, vq, vq);
      float4* d = dst + (q * kWords + w) * 8;
#pragma unroll
      for (int n = 0; n < 8; ++n) d[(t + n) & 7] = c;
    }
  }
}

// B's and C's step loop: each element's sum over `iters` steps in the order
// of k, a group of U steps of N lookups each at a time.  `group(k)`, k a
// group's first step (a multiple of U), returns the group's lookups: its
// (u * N + n) is lookup n of step k + u.  The lookups do not depend on the
// sum, so each lookup of the next group is loaded beside an add of this
// one: groups run in pairs, a and b taking turns, so no value is moved
// between them (a group past the last stays in the table, unused).  The
// steps past the last whole group read the lookups of the group they would
// begin, unrolled.
template <int U, int N, typename Group>
__device__ __forceinline__ float sum_steps(Group group, int iters) {
  float acc = 0.f;
  auto add_load = [&](const float (&v)[U * N], unsigned k,
                      float (&next)[U * N]) {
    const auto g = group(k);
#pragma unroll
    for (int i = 0; i < U * N; ++i) {
      acc = acc + v[i];
      next[i] = g(i);
    }
  };
  float a[U * N], b[U * N];
  {
    const auto g = group(0u);
#pragma unroll
    for (int i = 0; i < U * N; ++i) a[i] = g(i);
  }
  const int groups = iters / U;
  int h = 0;
  for (; h + 2 <= groups; h += 2) {
    add_load(a, static_cast<unsigned>(h + 1) * U, b);
    add_load(b, static_cast<unsigned>(h + 2) * U, a);
  }
  if (h < groups) {
#pragma unroll
    for (int i = 0; i < U * N; ++i) acc = acc + a[i];
  }
  const int rest = iters - groups * U;
  const auto g = group(static_cast<unsigned>(groups) * U);
#pragma unroll
  for (int u = 0; u < U - 1; ++u) {
    if (u >= rest) break;
#pragma unroll
    for (int n = 0; n < N; ++n) acc = acc + g(u * N + n);
  }
  return acc;
}

// B's steps a group, U, and the words of its copied row: the row's 128,
// then its first U - 1 again, so that step u of a group whose first step
// reads word j reads word j + u, at an offset fixed at compile time.  U is
// 32 / K (32 at K = 1, 8 at K = 4), and 1 at K = 12, whose 12 lookups
// already fill a step's 12 dependent adds.
template <int K>
struct LanesGroup {
  static constexpr int U = K > 4 ? 1 : kGroupLoads / K;
  static constexpr int kWords = kLanes + U - 1;
  static constexpr int kBytes = K * kWords * kBanks * sizeof(float);
};

// P4-b: block b holds tile row b (its 128 elements, 4 warps) and the K
// copied tiles of that row (K x 16 KB, and U - 1 words more).  A group of U
// steps' K U lookups is read from one base, j = (j0 + k) % 128.
template <int K>
__global__ void __launch_bounds__(kLanesThreads) lanes_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, int iters,
    float* __restrict__ out) {
  constexpr int U = LanesGroup<K>::U;
  constexpr int kWords = LanesGroup<K>::kWords;
  constexpr int kTileFloats = kWords * kBanks;  // one tile's copies
  extern __shared__ float4 xq4[];  // [K][kWords][8]: x + q, copied
  const int t = static_cast<int>(threadIdx.x);
  const int e = static_cast<int>(blockIdx.x) * kLanesThreads + t;
  const int row = e - e % kLanes;
  fill_copies<K, kLanesThreads, kWords, kLanes>(xq4, x + row);
  const unsigned j0 = static_cast<unsigned>(__ldg(idx + e));
  __syncthreads();
  const float* xl = reinterpret_cast<const float*>(xq4) + t % kBanks;
  // lookup u * K + q of the group from step k: (x + q)[row, (j0 + k + u) %
  // 128], q in order
  out[e] = sum_steps<U, K>(
      [&](unsigned k) {
        const float* p = xl + ((j0 + k) & (kLanes - 1)) * kBanks;
        return [p](int i) { return p[i % K * kTileFloats + i / K * kBanks]; };
      },
      iters);
}

// P4-c: block b holds elements b * 32 .. b * 32 + 31 (one row, columns c0
// .. c0 + 31), all of x copied (128 KB) and its columns' 8 rows of the
// lane table (lane l's at s * 32 + l).  Step k of a group of 8 reads row
// s = (s0 + k) & 7, a per-lane constant of k % 8.
__global__ void __launch_bounds__(kFusedThreads) fused_kernel(
    const float* __restrict__ x, const int* __restrict__ lane,
    const int* __restrict__ srow, int iters, float* __restrict__ out) {
  constexpr int U = kFusedGroup;  // (s0 + k) & 7 has period 8
  extern __shared__ float4 xc4[];  // [1024 words][8]: x, copied
  __shared__ unsigned ls[kRows * kFusedThreads];
  const int t = static_cast<int>(threadIdx.x);
  const int e = static_cast<int>(blockIdx.x) * kFusedThreads + t;
  const int c = e % kLanes;
  fill_copies<1, kFusedThreads, kTile, kTile>(xc4, x);
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    ls[s * kFusedThreads + t] =
        static_cast<unsigned>(__ldg(lane + s * kLanes + c));
  }
  const unsigned s0 = static_cast<unsigned>(__ldg(srow + e));
  __syncthreads();
  const float* xl = reinterpret_cast<const float*>(xc4) + t % kBanks;
  // step u of a group: its row s_u's lane-table entry, a load a step (the
  // TPU probe's lane gather reads the table each step), and copies of x
  const volatile unsigned* lt_u[U];
  const float* x_u[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = static_cast<int>((s0 + u) & (kRows - 1));
    lt_u[u] = ls + s * kFusedThreads + t;
    x_u[u] = xl + s * kLanes * kBanks;
  }
  out[e] = sum_steps<U, 1>(
      [&](unsigned k) {
        return [&, k](int u) {
          const unsigned j = (*lt_u[u] + k + u) & (kLanes - 1);
          return x_u[u][j * kBanks];
        };
      },
      iters);
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

// Lets `kernel` take `bytes` of dynamic shared memory; once per process
// (each caller's static).
cudaError_t allow_shared(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// B's and C's one grid each, a tile element a thread, every element once.
static_assert(kTile % kLanesThreads == 0 && kLanesThreads == kLanes,
              "B's blocks are whole tile rows");
static_assert(kTile % kFusedThreads == 0 && kFusedThreads == kBanks,
              "C's blocks are one warp");

template <int K>
int launch_lanes(const float* x, const int* idx, int iters, float* out,
                 cudaStream_t s) {
  constexpr int bytes = LanesGroup<K>::kBytes;
  static const cudaError_t allowed =
      allow_shared(reinterpret_cast<const void*>(lanes_kernel<K>), bytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  lanes_kernel<K><<<kTile / kLanesThreads, kLanesThreads, bytes, s>>>(
      x, idx, iters, out);
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
// or 12 (the TPU probe's).  Another K or a negative iters returns
// cudaErrorInvalidValue.
extern "C" int dpt_probe_crossbar_lanes(const float* x, const int* idx,
                                        int K, int iters, float* out,
                                        void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_lanes<1>(x, idx, iters, out, s);
    case 4: return launch_lanes<4>(x, idx, iters, out, s);
    case 12: return launch_lanes<12>(x, idx, iters, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P4-c; a negative iters returns cudaErrorInvalidValue.
extern "C" int dpt_probe_crossbar_fused(const float* x, const int* lane,
                                        const int* srow, int iters,
                                        float* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = kTile * kBanks * sizeof(float);
  static const cudaError_t allowed =
      allow_shared(reinterpret_cast<const void*>(fused_kernel), bytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  fused_kernel<<<kTile / kFusedThreads, kFusedThreads, bytes,
                 static_cast<cudaStream_t>(stream)>>>(x, lane, srow, iters,
                                                      out);
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

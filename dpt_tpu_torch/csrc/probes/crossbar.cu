// P3 and P4 on Hopper: the per-lane lookup primitives of
// scripts/attic/probe_gather.py and scripts/probe_crossbar.py, each a loop
// over one tile spread over SMs: A, C, D, E and P3-b in blocks of one warp,
// B and P3-a in 8 blocks of 128.
//
// Replaces the two Pallas kernels of scripts/attic/probe_gather.py
// `pallas_gather_probe` :64, acc from 0 and every sum in the order of k:
//   P3-a `kern` :66 (pallas_call :82), x f32 [8, 128], 1,000 steps:
//        acc[r, c] += x[r, (idx[r, c] + k) % 128]
//   P3-b `kern0` :98 (pallas_call :113), x f32 [64, 128], 100 steps:
//        acc[r, c] += x[(idx[r, c] + k) % 64, c]
// and the five Pallas kernels of scripts/probe_crossbar.py, run by
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
// A and D (`sublane_kernel`, `rows_kernel`).  The first port ran each in one
// block of 1024 threads, one SM for the whole tile: A at that SM's issue of
// 32 warps' index arithmetic and lookups (~66 clocks a step), D at 8 loads a
// thread in flight from L2 (~42 ns a step, ~49 B a clock into one SM).  Now
// block b of 32 holds elements b * 32 .. b * 32 + 31: tile row b / 4,
// columns (b % 4) * 32 + lane.  A looks across rows, beyond a warp shuffle,
// so each block copies its 32 columns of x's 8 rows (1 KB) into shared
// memory, lane l's word of row j at j * 32 + l, always bank l: every lookup
// is one wavefront with no copy a bank.  It runs B's and C's step loop
// (`sum_steps`) with A's lookup alone: row (s0 + k) & 7 takes 8 values a
// lane, so their 8 offsets are computed once, and each step still loads its
// word by a volatile load (as C reads its lane table: the compiler would
// otherwise keep the 8 words in registers and price no lookup).  D's table
// (2 MB) does not fit in shared memory (227 KB at most): it stays in device
// memory and L2, and each step of a block needs one contiguous 128-byte
// slice of it, row start + b / 4, which one lane (elect.sync) asks the copy
// engine for (cp.async.bulk, completion on an mbarrier) into a shared-memory
// ring: kRowsGroup steps a stage on one mbarrier, kRowsStages stages (128
// steps ahead, 16 KB).  The issuing lane takes each stage's addresses from
// registers loaded a turn ahead, out of a chunk of 128 computed by the whole
// block (rows * 8 wrapping in int32, clamped as `pl.ds` is), the rows of
// the next chunk read while this one runs, so no step waits on a global
// load.  The block waits on a stage's parity, loads its slices, hands the
// slot back (one barrier) before it is refilled, and adds them in the order
// of k; the last stage expects only the bytes it copies, and a copy that
// never lands traps (mbar_wait).  No proxy fence orders the slot's reads
// before its refill (the barrier does, as in CUTLASS's pipelines):
// fence.proxy.async compiles to MEMBAR.ALL.CTA, which waits for the rows'
// loads in flight at every stage.
// E keeps v in a register: 141 dependent operations a step per element.
// -fmad=false and float literals (1.0001f, 0.5f) keep each multiply and add
// rounded apart, as the plain version's; XLA contracts E's chain, so E is
// held to the JAX probe within a rounding, and to the plain version bit for
// bit.
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
// What bounds A and D now.  A: each element's sum, a chain of 2,000
// dependent adds at ~4 clocks (2.09 SASS instructions a step issue beside
// it), then the launch and the 1 KB copy.  D: its SM's copy unit.  On an
// H100 (700 W) a block's 128-byte bulk copies, issued back to back, go at
// about one per 55 clocks (28 ns a step) whatever the ring's depth (128 to
// 512 steps) or the stage (16 to 64 steps); 512-byte copies into blocks
// of 128 threads issued by four warps took 33 ns a copy, a quarter of the
// rows multicast over a cluster of 4 blocks 37-41 ns, a branch around each
// copy 46 ns, and an mbarrier a step, not a stage, 99 ns
// (scripts/torch_crossbar_shapes.py on edited copies).  So D runs at ~7
// times its add chain, under the 40 ns a step of one block of 1024
// threads loading from L2.  E in one block (the first port) was bound by
// its SM's issue of 1024 x 141 float operations a step (128 a clock: about
// 1,128 clocks a step); spread as 32 blocks of one warp, one warp an SM, no
// SM's issue binds and the chain's latency does: 141 dependent operations
// of ~4 clocks a step
// (probes/__init__.py latency_bound_ms).  The clocks a dependent operation
// of that bound are the card's, read apart from E's code by a bare chain
// of multiplies and adds (op_chain_kernel, dpt_probe_crossbar_op_cycles);
// E's own clocks an operation (dpt_probe_crossbar_math_cycles) are printed
// beside them.
//
// P3 (`lanes_kernel<1>`, `column_kernel`).  The first port ran each in one
// block of 1024 threads on one SM (P3-b 8 elements a thread), whose
// shared-memory pipe served all 32 warps: 51.1 and 305.9 ns a step.  P3-a
// is B at K = 1 over half the steps, so it launches B's kernel: B's table
// holds x + 0.0f, which differs from x only at -0.0f, and a sum that starts
// at +0 never becomes -0 by adding a zero of either sign, so the two sums
// are equal bit for bit.  P3-b is A's lookup over 64 rows: lane t reads
// only its own column.  Block b of one warp holds elements b * 32 .. b * 32
// + 31 of the [64, 128] tile (one row, 32 columns) and copies those columns
// of all 64 rows into shared memory, lane t's word of row j at j * 32 + t,
// always bank t, then the column's first U - 1 rows again (12 KB).  The
// period, 64, is too long for A's per-lane offsets held in registers, so
// P3-b takes B's group instead: U steps read from one base at offsets fixed
// at compile time, and the index costs an add, a mask and a shift a group.
// Each lookup is a volatile load, as A's: at U = 32 a pair of groups spans
// the period, and the compiler hoisted the 64 lookups out of the loop.
// Each runs one grid, fixed in its entry point.  What bounds them now: the
// launch and the fill, then the chain.  On an H100 (700 W) P3-a takes
// 0.0086 ms, 5.6 us of it at 0 steps, its loop 3.0 ns a step (its chain
// of 1,000 adds 2.03 us); P3-b 0.0062 ms, 5.8 us of it at 0 steps (the 8
// KB column fill), its loop 2.06 SASS instructions a step.  P3-b at 8
// elements a thread (32 blocks, rows r, r + 8, ..., 8 sums side by side)
// took 1.22 times as long: its warp issues 8 lookups and adds a step
// (scripts/torch_crossbar_shapes.py).

#include "probe_common.cuh"

namespace {

using dpt::probe::dyn_start;
using dpt::probe::kTile;
constexpr int kLanes = 128;
constexpr int kRows = 8;
constexpr int kSublaneThreads = 32;  // A's threads a block: one warp
constexpr int kRowsThreads = 32;  // D's threads a block: one warp
constexpr int kRowsGroup = 16;  // D's steps a stage, on one mbarrier
constexpr int kRowsStages = 8;  // D's stages in its ring
constexpr int kRowsAhead = kRowsGroup * kRowsStages;  // D's ring, in steps
constexpr int kMathOps = 70;   // P4-e's multiply-adds a step
constexpr int kMathThreads = 32;  // P4-e's threads a block: one warp
constexpr int kChainPairs = 512;  // the bare chain's multiply-adds a step
constexpr int kBanks = 32;  // shared-memory banks: a lookup table's copies
constexpr int kLanesThreads = 128;  // B's threads a block: one tile row
constexpr int kGroupLoads = 32;  // B's lookups a group: 32 / K steps
constexpr int kFusedThreads = 32;  // C's threads a block: one warp
constexpr int kFusedGroup = 8;  // C's steps a group, a multiple of 8
constexpr int kRows0 = 64;  // P3-b's tile rows
constexpr int kTile0 = kRows0 * kLanes;  // P3-b's tile
constexpr int kColumnThreads = 32;  // P3-b's threads a block: one warp
constexpr int kColumnGroup = 32;  // P3-b's steps a group (U)

// D's block barrier: a warp's alone for a one-warp block.
__device__ __forceinline__ void sync_rows_block() {
  if constexpr (kRowsThreads == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
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

// P4-a: block b of T = kSublaneThreads threads holds elements b * T ..
// b * T + T - 1 (in one tile row) and their columns of x's 8 rows, thread
// t's word of row j at j * T + t (bank t % 32).  A thread reads only the
// words it wrote, so a warp's barrier is enough whatever T.  Step k reads
// row (s0 + k) & 7, a per-lane constant of k % 8, by a volatile load: one
// shared load a step.
__global__ void __launch_bounds__(kSublaneThreads) sublane_kernel(
    const float* __restrict__ x, const int* __restrict__ sub, int iters,
    float* __restrict__ out) {
  constexpr int T = kSublaneThreads;
  __shared__ float xs[kRows * T];
  const int t = static_cast<int>(threadIdx.x);
  const int e = static_cast<int>(blockIdx.x) * T + t;
  const int c = e % kLanes;
#pragma unroll
  for (int j = 0; j < kRows; ++j) xs[j * T + t] = __ldg(x + j * kLanes + c);
  const unsigned s0 = static_cast<unsigned>(__ldg(sub + e));
  __syncwarp();
  const volatile float* x_u[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    x_u[u] = xs + static_cast<int>((s0 + u) & (kRows - 1)) * T + t;
  }
  out[e] = sum_steps<kRows, 1>(
      [&](unsigned) { return [&](int u) { return *x_u[u]; }; }, iters);
}

// P3-b: block b of T = kColumnThreads threads (one warp) holds elements b *
// T .. b * T + T - 1 (in one row of the [64, 128] tile) and their columns
// of all 64 rows, lane t's word of row j at j * T + t (bank t), then rows 0
// .. U - 2 again.  A thread reads only the words it wrote.  A group of U
// steps from step k reads rows j .. j + U - 1, j = (j0 + k) % 64, from one
// base.
__global__ void __launch_bounds__(kColumnThreads) column_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, int iters,
    float* __restrict__ out) {
  constexpr int T = kColumnThreads, U = kColumnGroup;
  __shared__ float xs[(kRows0 + U - 1) * T];
  const int t = static_cast<int>(threadIdx.x);
  const int e = static_cast<int>(blockIdx.x) * T + t;
  const int c = e % kLanes;
  float v[kRows0];  // all of the column's loads in flight at once
#pragma unroll
  for (int j = 0; j < kRows0; ++j) v[j] = __ldg(x + j * kLanes + c);
#pragma unroll
  for (int j = 0; j < kRows0 + U - 1; ++j) xs[j * T + t] = v[j % kRows0];
  const unsigned j0 = static_cast<unsigned>(__ldg(idx + e));
  __syncwarp();
  // lookup u of the group from step k: x[(j0 + k + u) % 64, c], by a
  // volatile load (a pair of groups spans the period)
  const volatile float* xl = xs + t;
  out[e] = sum_steps<U, 1>(
      [&](unsigned k) {
        const volatile float* p = xl + ((j0 + k) & (kRows0 - 1)) * T;
        return [p](int u) -> float { return p[u * kColumnThreads]; };
      },
      iters);
}

// D's dynamic shared memory: the ring of kRowsStages stages of kRowsGroup
// slices of kRowsThreads floats.
constexpr int kRowsRingBytes =
    kRowsAhead * kRowsThreads * static_cast<int>(sizeof(float));

// One lane of the calling warp, by elect.sync: the compiler then knows a
// copy issued under it is issued once, with no loop over active lanes.
__device__ __forceinline__ bool elect_one() {
  uint32_t one;
  asm volatile(
      "{\n.reg .b32 r;\n.reg .pred p;\n"
      "elect.sync r|p, 0xffffffff;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(one));
  return one != 0;
}

// P4-d: block b of T = kRowsThreads threads holds elements e0 = b * T ..
// e0 + T - 1 (in one tile row), so step k's slice is the T floats at tab +
// start_k * 128 + e0, start_k the first row of its block.  Stage i (steps
// i G .. i G + G - 1) lands in slot i % S, on the phase i / S of that
// slot's mbarrier; it is issued at turn j = i by one lane of warp 0, which
// arms the mbarrier with the stage's bytes, and consumed at turn j = i +
// S.  The slices' addresses are kept a chunk of S stages (W steps) at a
// time, chunk c's written at turn c S from rows read during chunk c - 1,
// and a stage's in registers from the turn before its issue.
__global__ void __launch_bounds__(kRowsThreads) rows_kernel(
    const float* __restrict__ tab, int n_rows, const int* __restrict__ rows,
    int iters, float* __restrict__ out) {
  constexpr int T = kRowsThreads;
  constexpr int G = kRowsGroup, S = kRowsStages, W = kRowsAhead;
  constexpr int kPer = W / T;  // rows each thread reads a chunk
  constexpr uint32_t kSliceBytes = T * sizeof(float);
  extern __shared__ __align__(128) float ring[];  // [S][G][T]
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(16) const float* src[W];  // each step's slice
  const int t = static_cast<int>(threadIdx.x);
  const int e0 = static_cast<int>(blockIdx.x) * T;
  const float* tab0 = tab + e0;
  const int n_stages = (iters + G - 1) / G;
  const int turns = n_stages > 0 ? n_stages + S : 0;

  int pre[kPer];
  auto read_rows = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = k0 + i * T + t;
      pre[i] = k < iters ? __ldg(rows + k) : 0;
    }
  };
  read_rows(0);
  if (t == 0) {
#pragma unroll 1
    for (int s = 0; s < S; ++s) dpt::probe::mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float acc = 0.f;
  for (int j0 = 0; j0 < turns; j0 += S) {
    sync_rows_block();  // the last chunk's addresses are read
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      // rows[k] * 8 wraps in int32, as in JAX
      const int r8 = static_cast<int>(static_cast<unsigned>(pre[i]) * kRows);
      src[i * T + t] = tab0 + dyn_start(r8, n_rows, kRows) * kLanes;
    }
    sync_rows_block();
    read_rows((j0 + S) * G);  // the next chunk's rows, in flight
    const float* a[G];  // the slices of the stage issued next
#pragma unroll
    for (int u = 0; u < G; ++u) a[u] = src[u];
    const int j1 = min(j0 + S, turns);
    for (int j = j0; j < j1; ++j) {
      const int slot = j % S;
      float v[G];
      int n = 0;
      if (j >= S) {  // consume stage j - S
        const int i = j - S;
        dpt::probe::mbar_wait(&full[slot], static_cast<uint32_t>((i / S) & 1));
        n = min(G, iters - i * G);
        const float* sl = ring + slot * G * T + t;
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (u < n) v[u] = sl[u * T];
        }
        sync_rows_block();  // every thread has read the slot
      }
      if (j < n_stages && t < 32 && elect_one()) {
        const int m = min(G, iters - j * G);
        float* dst = ring + slot * G * T;
        dpt::probe::mbar_expect(&full[slot], m * kSliceBytes);
        if (m == G) {
          // a whole stage's copies back to back, their addresses moved to
          // uniform registers first: a branch around each copy (the short
          // stage's form) made D 1.6x slower
#pragma unroll
          for (int u = 0; u < G; ++u) {
            dpt::probe::bulk_copy(dst + u * T, a[u], kSliceBytes,
                                  &full[slot]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < G; ++u) {
            if (u < m) {
              dpt::probe::bulk_copy(dst + u * T, a[u], kSliceBytes,
                                    &full[slot]);
            }
          }
        }
      }
      if (j + 1 < j0 + S) {
#pragma unroll
        for (int u = 0; u < G; ++u) a[u] = src[(j + 1 - j0) * G + u];
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (u < n) acc = acc + v[u];
      }
    }
  }
  out[e0 + t] = acc;
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

// Each kernel's one grid, a tile element a thread, every element once.
static_assert(kTile % kLanesThreads == 0 && kLanesThreads == kLanes,
              "B's blocks are whole tile rows");
static_assert(kTile % kFusedThreads == 0 && kFusedThreads == kBanks,
              "C's blocks are one warp");
static_assert(kTile % kSublaneThreads == 0 &&
                  kLanes % kSublaneThreads == 0 && kSublaneThreads % 32 == 0,
              "A's blocks are whole warps within a tile row");
static_assert(kTile % kRowsThreads == 0 && kLanes % kRowsThreads == 0 &&
                  kRowsThreads % 32 == 0 && kRowsAhead % kRowsThreads == 0,
              "D's blocks are whole warps within a tile row");
static_assert((kRowsStages & (kRowsStages - 1)) == 0,
              "D's stages are a power of 2");
static_assert(kRowsThreads * sizeof(float) % 16 == 0,
              "D's slices are whole 16-byte units of a bulk copy");
static_assert(kTile0 % kColumnThreads == 0 && kLanes % kColumnThreads == 0 &&
                  kColumnThreads == kBanks,
              "P3-b's blocks are one warp within a tile row");
static_assert((kRows0 & (kRows0 - 1)) == 0 && kColumnGroup <= kRows0,
              "P3-b's row is the low bits of its index, a group's rows "
              "wrap at most once");

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
// Tiles are [8, 128] (x f32; sub, idx, lane, srow int32), out f32 [8, 128],
// but P3-b's [64, 128].
// P3-a: B's kernel at K = 1 in its grid (8 blocks of 128, a tile row
// each); a negative iters returns cudaErrorInvalidValue.
extern "C" int dpt_probe_gather_axis1(const float* x, const int* idx,
                                      int iters, float* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes<1>(x, idx, iters, out,
                         static_cast<cudaStream_t>(stream));
}

// P3-b: the [64, 128] tile in blocks of one warp; a negative iters returns
// cudaErrorInvalidValue.
extern "C" int dpt_probe_gather_axis0(const float* x, const int* idx,
                                      int iters, float* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  column_kernel<<<kTile0 / kColumnThreads, kColumnThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, idx, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// P4-a: the tile in blocks of kSublaneThreads; a negative iters returns
// cudaErrorInvalidValue.
extern "C" int dpt_probe_crossbar_sublane(const float* x, const int* sub,
                                          int iters, float* out,
                                          void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  sublane_kernel<<<kTile / kSublaneThreads, kSublaneThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, sub, iters, out);
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

// P4-d: tab f32 [n_rows, 128], rows int32 [iters], the tile in blocks of
// kRowsThreads.  A negative iters, fewer than 8 rows or a table whose base
// is not 16-byte aligned (a bulk copy's source must be) returns
// cudaErrorInvalidValue.
extern "C" int dpt_probe_crossbar_rows(const float* tab, int n_rows,
                                       const int* rows, int iters,
                                       float* out, void* stream) {
  if (iters < 0 || n_rows < kRows ||
      reinterpret_cast<uintptr_t>(tab) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kRowsRingBytes > 48 * 1024) {  // past the default limit
    static const cudaError_t allowed = allow_shared(
        reinterpret_cast<const void*>(rows_kernel), kRowsRingBytes);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
  }
  rows_kernel<<<kTile / kRowsThreads, kRowsThreads, kRowsRingBytes,
                static_cast<cudaStream_t>(stream)>>>(tab, n_rows, rows,
                                                     iters, out);
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

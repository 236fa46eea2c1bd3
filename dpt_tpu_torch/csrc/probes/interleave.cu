// P5 and P6 on Hopper: P independent pointer-chase chains over one ray
// tile, each step a dependent record load and a slab pair, the tile spread
// over several SMs.
//
// Replaces scripts/probe_interleave.py::make (P5, pallas_call :94) and
// scripts/attic/probe_interleave_any.py::make (P6, pallas_call :97): one
// Pallas program over an [8, 128] ray tile per chain, P chains, ITERS
// steps.  Step of chain p, for every element of the tile:
//   rec = record rid of the [8192, 16] view of nodes
//   (ltn, ltf), (rtn, rtf) = slabs of fields 0-5 and 6-11
//   hit = ltn <= ltf && ltf >= 0;  acc += hit ? ltn : rtn
//   rid = floor_mod(trunc(rec[12]) + rid [+ any(hit) over the tile], 8192)
// from rid = 7p + 1.  P6 adds the tile-wide any(hit) into the next index,
// so the reduction sits on the chain of dependent loads.
//
// What bounds it: a chain is a sequence of dependent steps, so its time is
// steps x the latency of one step (the record load, and in P6 the slab
// pair and the tile-wide any), far above the card's operations bound (1024
// x 51 float operations a step and chain).  One block of 1024 threads on
// one SM (the first port) was bound by that SM's issue rate instead: 32
// warps each issued every step's ~51 operations before the next load could
// leave.
//
// Design: the tile is spread over 1024 / T blocks of T threads, one thread
// per element, each thread running the P chains unrolled in registers so
// that P record loads are in flight at once.  The chain index depends on
// the table alone (in P6 also on the tile's any), so every block computes
// the same index itself and no block waits on another for it: an SM then
// issues T x 51 operations a step and chain, not 1024 x 51.  The record is
// one broadcast load (four 16-byte __ldg, one address for the whole warp;
// one lane's load passed on by 16 shuffles was up to 1.55x slower in P5).
//   P5: 32 independent blocks of one warp (T = 32; 64-256 were slower).
//   P6: one cluster of 8 blocks of 128 threads (S = 2 was slower; S = 4
//       and 16 were at most 3% faster, each at one P only).
//       Each step every warp ORs its hits into one word (bit p: chain p;
//       __reduce_or_sync) and sends it, as the tile's warp w of 32, into
//       slot w of every block of the cluster with st.async, which counts
//       its 4 bytes into that block's mbarrier; each block waits on its own
//       mbarrier for the 128 bytes of the step (one wait for all P chains),
//       then ORs its 32 slots.  Slots and mbarriers are double-buffered by
//       step parity: a warp sends the word of step it + 2 only after its
//       block has received every word of step it + 1, which each warp sends
//       after it has read the slots of step it.  (A hardware cluster barrier
//       a step, barrier.cluster.arrive.release / wait.acquire, and a
//       polled word tagged with its step were 1.8-2.4x and 1.3-1.7x slower
//       at the best shape of each P.)
// The output also carries a sink per chain (0, the final index, 0), the
// layout P2 shares.  Built with -fmad=false: the plain PyTorch version
// (probes/probe_interleave.py) gives the same values bit for bit.

#include <cooperative_groups.h>

#include <cstdint>

#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

using dpt::probe::kRecords;
using dpt::probe::kTile;
using dpt::probe::kWarps;
using dpt::probe::mbar_expect_step;
using dpt::probe::mbar_init;
using dpt::probe::mbar_wait;
using dpt::probe::send_word;

constexpr unsigned kFull = 0xffffffffu;

template <int P, bool kAny, int T>
__global__ void __launch_bounds__(T) interleave_kernel(
    const float4* __restrict__ nodes, const float* __restrict__ rays,
    int iters, float* __restrict__ out, int* __restrict__ sink,
    int* __restrict__ sm_of_block) {
  // P6: slots[parity][w] is warp w's OR of its hits at the steps of that
  // parity (bit p for chain p); bar[parity] completes when all 32 landed.
  __shared__ unsigned slots[2][kAny ? kWarps : 1];
  __shared__ __align__(8) uint64_t bar[2];
  const int x = static_cast<int>(threadIdx.x);
  const int i = static_cast<int>(blockIdx.x) * T + x;
  const int lane = x & 31;
  dpt::Ray ray[P];
  float acc[P];
  int rid[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ray[p] = dpt::probe::load_tile_ray(rays, p, i);
    acc[p] = 0.f;
    rid[p] = 7 * p + 1;
  }
  if constexpr (kAny) {
    if (x == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_step(&bar[0]);
      mbar_expect_step(&bar[1]);
    }
    // Every block's mbarriers are set before the first word is sent.
    cg::this_cluster().sync();
  }
  for (int it = 0; it < iters; ++it) {
    int nxt[P];
    bool hit[P];
    float pick[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float f[16];
      dpt::probe::load_record(nodes, rid[p], f);
      float ltn, ltf, rtn, rtf;
      dpt::probe::slab_pair(f, ray[p], ltn, ltf, rtn, rtf);
      hit[p] = ltn <= ltf && ltf >= 0.f;
      pick[p] = hit[p] ? ltn : rtn;
      nxt[p] = static_cast<int>(f[12]) + rid[p];
    }
    if constexpr (kAny) {
      unsigned bits = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) bits |= hit[p] ? 1u << p : 0u;
      bits = __reduce_or_sync(kFull, bits);
      const int par = it & 1;
      if (lane < kTile / T) {
        send_word(&slots[par][i >> 5], &bar[par], lane, bits);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = acc[p] + pick[p];
      mbar_wait(&bar[par], static_cast<uint32_t>((it >> 1) & 1));
      const unsigned any = __reduce_or_sync(kFull, slots[par][lane]);
      // The next phase of this parity: step it + 2.
      if (x == 0) mbar_expect_step(&bar[par]);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        rid[p] = dpt::probe::floor_mod(
            nxt[p] + static_cast<int>((any >> p) & 1u), kRecords);
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        acc[p] = acc[p] + pick[p];
        rid[p] = dpt::probe::floor_mod(nxt[p], kRecords);
      }
    }
  }
  if constexpr (kAny) {
    // No block exits while a word may still be on its way to it.
    cg::this_cluster().sync();
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[p * kTile + i] = acc[p];
    if (i == 0) {
      sink[3 * p + 0] = 0;
      sink[3 * p + 1] = rid[p];
      sink[3 * p + 2] = 0;
    }
  }
  if (sm_of_block != nullptr && x == 0) {
    unsigned sm;
    asm("mov.u32 %0, %%smid;" : "=r"(sm));
    sm_of_block[blockIdx.x] = static_cast<int>(sm);
  }
}

using KernelFn = void (*)(const float4*, const float*, int, float*, int*,
                          int*);

// The threads a block of each kernel: P5 (no any) in 32 blocks of 32
// without a cluster, P6 in one cluster of 8 blocks of 128.
constexpr int kP5Threads = 32;
constexpr int kP6Threads = 128;

template <int P>
KernelFn kernel_of_p(int any) {
  return any ? interleave_kernel<P, true, kP6Threads>
             : interleave_kernel<P, false, kP5Threads>;
}

// The kernel of a shape the library takes, or null: `blocks` blocks of
// `threads` cover the 1024 tile elements once, P5 (any = 0) in blocks of
// 32 without a cluster (cluster = 1), P6 in one cluster of all its blocks
// of 128.
KernelFn checked_kernel(int P, int any, int threads, int cluster,
                        int blocks) {
  if (threads != (any ? kP6Threads : kP5Threads) ||
      blocks * threads != kTile || cluster != (any ? blocks : 1)) {
    return nullptr;
  }
  switch (P) {
    case 1: return kernel_of_p<1>(any);
    case 2: return kernel_of_p<2>(any);
    case 4: return kernel_of_p<4>(any);
    case 8: return kernel_of_p<8>(any);
    default: return nullptr;
  }
}

}  // namespace

// One launch on `stream`: nodes [8192 x 16] f32 (16-byte aligned), rays
// [P][6][1024] f32, out [P][1024] f32, sink [P][3] int32, and, unless
// null, sm_of_block [blocks] int32 (the SM each block ran on).  `any`
// selects P6 (the tile's any(hit) in the next index).  The shape: P5 in
// `blocks` = 32 blocks of `threads` = 32 with `cluster` = 1; P6 in one
// cluster of `cluster` = `blocks` = 8 blocks of 128.  P is 1, 2, 4 or 8.  A
// P, shape or grid the library does not take returns
// cudaErrorInvalidValue; else the launch's error (a refused cluster
// included), then cudaGetLastError().
extern "C" int dpt_probe_interleave(const float* nodes, const float* rays,
                                    int P, int iters, int any, int threads,
                                    int cluster, int blocks, float* out,
                                    int* sink, int* sm_of_block,
                                    void* stream) {
  const KernelFn kernel = checked_kernel(P, any, threads, cluster, blocks);
  if (kernel == nullptr || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = any ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const float4*>(nodes),
                         rays, iters, out, sink, sm_of_block);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Registers and local bytes per thread of the kernel of P chains in a
// shape the library takes (as dpt_probe_interleave checks it).
extern "C" int dpt_probe_interleave_attrs(int P, int any, int threads,
                                          int cluster, int blocks,
                                          int* num_regs, int* local_bytes) {
  const KernelFn kernel = checked_kernel(P, any, threads, cluster, blocks);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// The probe library's error strings, under the render library's name
// (each library is loaded on its own).
extern "C" const char* dpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

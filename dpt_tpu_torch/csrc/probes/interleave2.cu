// P2 on Hopper: the walk-step variants A-D, P chains interleaved in each
// thread, each with a stack of 32 indices shared by the whole tile, the
// tile spread over a thread-block cluster.
//
// Replaces scripts/attic/probe_interleave2.py::make(P, variant)
// (pallas_call :160; `mt8` :33).  Step of chain p, for every element of
// the [8, 128] ray tile, with rec = record rid of the [8192, 16] view of
// nodes and the slab pair of fields 0-5 and 6-11 (interleave.cu):
//   lhit / rhit = the tile's any(tn <= tf && tf >= 0) of the left / right box
//   lptr / rptr = floor_mod(trunc(rec[12] / rec[13]) + rid, 8192)
//   A: rid = stack[0]; acc += ltn <= ltf ? ltn : rtn (no tf >= 0 here);
//      stack[0] = lhit ? lptr : rptr
//   B: rid = stack[max(sp - 1, 0)] (a pop); both hit: push lptr, rptr;
//      one hit: push its pointer; sp = max(min(sp' + lhit + rhit, 30), 1)
//   C: B, and where rec[14] > 0 && lhit (the same for the whole tile),
//      mt8 over leaf row rid % 512: a branch
//   D: B, and mt8 at every step
// mt8 is the probe's own Möller–Trumbore over the row's 8 slots: no valid
// field, a 1e-6 parallel test that only replaces det by 1, and t > 1e-6;
// acc takes t where ok && t < acc.  Every accumulator starts at 0 and mt8
// needs t > 1e-6 and t < acc, so B, C and D return zeros for every input,
// as the TPU probe does.
//
// The sink: the kernel also writes, per chain, the final sp, the final top
// of the stack (stack[max(sp - 1, 0)]; A: stack[0]) and the tile's count
// of mt8 slot tests with ok true.  It keeps nvcc from deleting work whose
// output is otherwise constant, and the plain version computes the same.
//
// What bounds it: a chain is a sequence of dependent steps (the record
// load, the slab pair, the tile-wide ORs, the stack), so its time is steps
// x the latency of one step, far above the card's operations bound.  The
// first port ran the tile as one block of 1024 threads on one SM, the ORs
// by __syncthreads_or: that SM's issue of 32 warps' work bound it (D at P
// = 8 read 54% of its one SM's operations bound), not the step's latency.
// Spread over a cluster, A and B take the exchange's latency a step (A
// within 9% of P6), while C and D wait on each warp's own mt8: one warp a
// scheduler runs ~88 instructions a slot test in ~225 clocks, each slot's
// IEEE reciprocal a call site in its own convergence region (on the H100:
// PERF.md; grouping the 8 slots' loads, determinants and reciprocals in
// the source did not overlap them).
//
// Design: P6's (interleave.cu).  The tile is spread over one cluster of 8
// blocks of 128 threads, one thread per element, the P chains unrolled in
// registers.  Each step every warp ORs its hits into one word
// (bit p: chain p's lhit, bit 8 + p: its rhit; A needs the low bits only)
// and sends it with st.async into slot w (its warp of the tile) of every
// block; each block waits on its own mbarrier for the step's 128 bytes,
// once for all P chains, then ORs its 32 slots (probe_common.cuh).  The
// record, the chain index, and so rid, sp and the stack are the same in
// every thread of the cluster, so each keeps its own copy: one per warp,
// in shared memory (a runtime-indexed stack in registers goes to local
// memory, which was slower at P = 8).  Every lane of a warp writes the
// same word; the warp's next read of its copy comes after the __syncwarp
// that ends the step, and its next write after the next step's OR of the
// warp's hits, which every lane reaches only after its reads: no warp
// waits on another for its stack.  A and D's work does not depend on the
// ORs, so it is issued while the words travel; C's branch on rec[14] > 0
// && lhit is taken or not by the whole cluster, after the wait, and its
// leaf row is read by broadcast __ldg.  The count of ok slot tests is
// summed by each warp and added into rank 0's shared word through
// distributed shared memory (integer sums: exact in any order).
// Built with -fmad=false: the plain version (probes/probe_interleave2.py)
// gives the same values bit for bit.

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
constexpr int kStackWords = 32;
constexpr int kTriRows = 512;
// The bit of chain p's rhit in a warp's word (its lhit is bit p).
constexpr int kRhitBit = 8;

// The probe's Möller–Trumbore over the 8 slots of leaf row `tr` (8 x 16
// floats: v0 at 0-2, e1 at 3-5, e2 at 6-8); counts each ok slot in n_ok.
__device__ __forceinline__ float mt8(const float4* __restrict__ tr,
                                     const dpt::Ray& r, float best,
                                     int& n_ok) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float4 a = __ldg(tr + 4 * s + 0);  // v0x v0y v0z e1x
    const float4 b = __ldg(tr + 4 * s + 1);  // e1y e1z e2x e2y
    const float e2z = __ldg(reinterpret_cast<const float*>(tr + 4 * s + 2));
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w;
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
    const float tx = r.ox - a.x, ty = r.oy - a.y, tz = r.oz - a.z;
    const float u = inv * (tx * px + ty * py + tz * pz);
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = inv * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float t = inv * (e2x * qx + e2y * qy + e2z * qz);
    const bool ok = u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
                    t > 1e-6f;
    n_ok += ok ? 1 : 0;
    best = ok && t < best ? t : best;
  }
  return best;
}

// The threads a block: one cluster of 8 blocks of 128 covers the tile,
// P6's shape (a cluster of 16 blocks of 64 was within 6% of it at every
// variant and P on the H100).
constexpr int kThreads = 128;
constexpr int kClusterBlocks = kTile / kThreads;

// V: 0 = A, 1 = B, 2 = C, 3 = D.
template <int P, int V>
__global__ void __launch_bounds__(kThreads) interleave2_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const float* __restrict__ rays, int iters, float* __restrict__ out,
    int* __restrict__ sink, int* __restrict__ sm_of_block) {
  static_assert(P <= kRhitBit, "a warp's word holds 8 chains' two hits");
  // slots[parity][w]: warp w's word of the steps of that parity;
  // bar[parity] completes when all 32 words of the step landed.
  __shared__ unsigned slots[2][kWarps];
  __shared__ __align__(8) uint64_t bar[2];
  // Each warp's copy of the P stacks.
  __shared__ int stacks[kThreads / 32][P][kStackWords];
  // Rank 0's: the cluster's count of ok slot tests per chain.
  __shared__ int n_ok_total[P];
  const cg::cluster_group cluster = cg::this_cluster();
  const int x = static_cast<int>(threadIdx.x);
  const int i = static_cast<int>(blockIdx.x) * kThreads + x;
  const int lane = x & 31;
  int(*stack)[kStackWords] = stacks[x >> 5];
  dpt::Ray ray[P];
  float acc[P];
  int sp[P], n_ok[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ray[p] = dpt::probe::load_tile_ray(rays, p, i);
    acc[p] = 0.f;
    sp[p] = 1;
    n_ok[p] = 0;
    if (lane == 0) stack[p][0] = 7 * p + 1;
  }
  if (x < P) n_ok_total[x] = 0;
  if (x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_step(&bar[0]);
    mbar_expect_step(&bar[1]);
  }
  // Every block's mbarriers, counters and stacks are set before the first
  // word is sent.
  cluster.sync();
  for (int it = 0; it < iters; ++it) {
    int rid[P], lptr[P], rptr[P];
    bool leaf[P];
    float pick[P];
    unsigned bits = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      rid[p] = stack[p][V == 0 ? 0 : max(sp[p] - 1, 0)];
      float f[16];
      dpt::probe::load_record(nodes, rid[p], f);
      float ltn, ltf, rtn, rtf;
      dpt::probe::slab_pair(f, ray[p], ltn, ltf, rtn, rtf);
      bits |= ltn <= ltf && ltf >= 0.f ? 1u << p : 0u;
      if constexpr (V != 0) {
        bits |= rtn <= rtf && rtf >= 0.f ? 1u << (kRhitBit + p) : 0u;
      }
      pick[p] = ltn <= ltf ? ltn : rtn;
      lptr[p] = dpt::probe::floor_mod(static_cast<int>(f[12]) + rid[p],
                                      kRecords);
      rptr[p] = dpt::probe::floor_mod(static_cast<int>(f[13]) + rid[p],
                                      kRecords);
      leaf[p] = f[14] > 0.f;
    }
    bits = __reduce_or_sync(kFull, bits);
    const int par = it & 1;
    if (lane < kClusterBlocks) {
      send_word(&slots[par][i >> 5], &bar[par], lane, bits);
    }
    // Work that needs no OR, while the words travel.
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if constexpr (V == 0) {
        acc[p] = acc[p] + pick[p];
      } else if constexpr (V == 3) {
        acc[p] = mt8(tris + 32 * (rid[p] % kTriRows), ray[p], acc[p],
                     n_ok[p]);
      }
    }
    mbar_wait(&bar[par], static_cast<uint32_t>((it >> 1) & 1));
    const unsigned any = __reduce_or_sync(kFull, slots[par][lane]);
    // The next phase of this parity: step it + 2.
    if (x == 0) mbar_expect_step(&bar[par]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool lhit = (any >> p) & 1u;
      if constexpr (V == 0) {
        stack[p][0] = lhit ? lptr[p] : rptr[p];
      } else {
        const bool rhit = (any >> (kRhitBit + p)) & 1u;
        if constexpr (V == 2) {
          if (leaf[p] && lhit) {
            acc[p] = mt8(tris + 32 * (rid[p] % kTriRows), ray[p], acc[p],
                         n_ok[p]);
          }
        }
        const int spm = max(sp[p] - 1, 0);
        if (lhit && rhit) {
          stack[p][spm] = lptr[p];
          stack[p][spm + 1] = rptr[p];
        } else if (lhit != rhit) {
          stack[p][spm] = lhit ? lptr[p] : rptr[p];
        }
        sp[p] = max(min(spm + (lhit ? 1 : 0) + (rhit ? 1 : 0), 30), 1);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[p * kTile + i] = acc[p];
    const int warp_ok = __reduce_add_sync(kFull, n_ok[p]);
    if (lane == 0) {
      atomicAdd(cluster.map_shared_rank(&n_ok_total[p], 0), warp_ok);
    }
  }
  // No block exits while a word may still be on its way to it, and rank 0
  // holds every block's count.
  cluster.sync();
  if (cluster.block_rank() == 0 && x == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sink[3 * p + 0] = sp[p];
      sink[3 * p + 1] = stack[p][V == 0 ? 0 : max(sp[p] - 1, 0)];
      sink[3 * p + 2] = n_ok_total[p];
    }
  }
  if (sm_of_block != nullptr && x == 0) {
    unsigned sm;
    asm("mov.u32 %0, %%smid;" : "=r"(sm));
    sm_of_block[blockIdx.x] = static_cast<int>(sm);
  }
}

using KernelFn = void (*)(const float4*, const float4*, const float*, int,
                          float*, int*, int*);

template <int P>
KernelFn kernel_of_v(int variant) {
  switch (variant) {
    case 0: return interleave2_kernel<P, 0>;
    case 1: return interleave2_kernel<P, 1>;
    case 2: return interleave2_kernel<P, 2>;
    case 3: return interleave2_kernel<P, 3>;
    default: return nullptr;
  }
}

// The kernel of a shape the library takes, or null: P chains (1 or 8),
// variant 0-3, and one cluster of 8 blocks of 128 threads.
KernelFn checked_kernel(int P, int variant, int threads, int cluster,
                        int blocks) {
  if (threads != kThreads || blocks != kClusterBlocks || cluster != blocks) {
    return nullptr;
  }
  switch (P) {
    case 1: return kernel_of_v<1>(variant);
    case 8: return kernel_of_v<8>(variant);
    default: return nullptr;
  }
}

}  // namespace

// One launch on `stream`: nodes [8192 x 16] f32 and tris [512 x 128] f32
// (both 16-byte aligned), rays [P][6][1024] f32, out [P][1024] f32, sink
// [P][3] int32, and, unless null, sm_of_block [blocks] int32 (the SM each
// block ran on).  `variant` 0-3 is A-D.  The shape: one cluster of
// `cluster` = `blocks` = 8 blocks of `threads` = 128.  A P (1 or 8),
// variant, shape or grid the library does not take returns
// cudaErrorInvalidValue; else the launch's error (a refused cluster
// included), then cudaGetLastError().
extern "C" int dpt_probe_interleave2(const float* nodes, const float* tris,
                                     const float* rays, int P, int variant,
                                     int iters, int threads, int cluster,
                                     int blocks, float* out, int* sink,
                                     int* sm_of_block, void* stream) {
  const KernelFn kernel = checked_kernel(P, variant, threads, cluster, blocks);
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
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), rays, iters, out, sink,
      sm_of_block);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Registers and local bytes per thread of the kernel of a shape the
// library takes (as dpt_probe_interleave2 checks it).
extern "C" int dpt_probe_interleave2_attrs(int P, int variant, int threads,
                                           int cluster, int blocks,
                                           int* num_regs, int* local_bytes) {
  const KernelFn kernel = checked_kernel(P, variant, threads, cluster, blocks);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

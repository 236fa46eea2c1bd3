// K3 on Hopper: brute-force nearest hit of each ray over every triangle.
//
// Replaces dpt_tpu/kernels/pallas_intersect.py::_kernel (the Pallas TPU
// kernel launched by _run, through pallas_nearest; traversal="brute" with
// kernels="intersect").  The table is the one pack_tris builds
// (dpt_tpu_torch/kernels/intersect.py): ceil(T/8) contiguous rows of 128
// floats (512 bytes), 8 triangles x 16 lanes (v0, e1 = v1 - v0, e2 = v2 -
// v0, oid, valid); padded slots have valid = 0 and never hit.  Each ray
// gets the nearest hit over every slot, t = 1e30 and tri = 0 on a miss,
// ties to the lowest slot (the strict t < best_t scan in slot order), with
// the caller's eps.
//
// What bounds it on this card: operations.  Every ray is tested against
// every slot, 54 float operations a test (chip_smoke.py's count), against
// 32 bytes of rays in and out per ray and the table read once.  So the
// design spends the SM's issue slots on the tests and little else:
//
//   - Triangle tiles in shared memory, loaded by the copy engine.  A tile
//     of kTileRows rows is one 1-D bulk copy (cp.async.bulk, global ->
//     shared, completion on an mbarrier; no tensor map: the rows are
//     contiguous), issued by thread 0 into a ring of kStages tiles, so the
//     next tiles land while the current one is tested.  Every thread reads
//     a slot with three broadcast LDS.128: no address arithmetic, no L1/L2
//     round trip, and none of the table's 238 KB (the 3,720-triangle
//     sphere) has to stay in L1.  A block's ring holds at most kStages x
//     kTileRows rows (24 KB, under the 48 KB default, so no attribute is
//     set); a short table takes one tile of its own length (the box's 2
//     rows: 1 KB), so a small table does not cost occupancy.
//   - R rays per thread (a template argument, 1 or 2).  Each slot read from
//     shared memory serves R tests, and the R tests are independent
//     dependency chains beside the IEEE reciprocal (MUFU and its Newton
//     step on the chain det -> 1/det -> u, v, t).  A ray is loaded as
//     origin and direction only: the walks' three slab reciprocals are not
//     computed.  The best slot is kept as an integer; the triangle id is
//     read from the table once per ray at the end, not converted at every
//     hit.
//   - The table split over a thread-block cluster of S blocks (a template
//     argument, 1 or 2), for streams whose rays alone cannot fill 132 SMs
//     over a long table: the blocks of a cluster hold the same rays, and
//     block q scans the rows [q n / S, (q + 1) n / S) in slot order.  Rank
//     0 then merges the S partial (t, slot) per ray through distributed
//     shared memory, keeping the smaller t and, on equal t, the lower
//     slice: the slices are in slot order, so this is the scan over the
//     whole table bit for bit.  One launch, no second pass, no atomics.
//
// The wrapper (kernels/intersect.py `_geometry`) picks R, S and the
// threads per block (128 or 256) from the ray and row counts, at
// crossovers timed on the card.  Every test is traverse_common.cuh
// `slot_test` as the walks run it, built with -fmad=false, so the kernel
// agrees with the plain PyTorch version (intersect_nearest_reference)
// exactly; padded slots are tested too, though the bound counts only the
// triangles.  A test issues about 72 instructions against the 54
// operations the bound counts (the IEEE reciprocal's range check and its
// branch, the hit compares and selects, the loads), which caps the kernel
// near three quarters of its bound on a table without padding.

#include <cooperative_groups.h>

#include <cstdint>

#include "traverse_common.cuh"

namespace cg = cooperative_groups;

namespace {

using dpt::kTMax;

constexpr int kRowFloat4 = 32;  // a table row: 8 slots x 4 float4
constexpr int kRowBytes = 512;
constexpr int kTileRows = 16;   // 8 KB a tile
constexpr int kStages = 3;
constexpr int kMaxThreads = 256;

// The ring of a block: rows per tile and tiles in flight, from the longest
// slice (ceil(n_rows / S) rows).  Host and device compute it alike.
struct Ring {
  int tile_rows;
  int stages;
};

__host__ __device__ inline Ring ring_of(int n_rows, int S) {
  const int rows = (n_rows + S - 1) / S;
  const int tile = rows < kTileRows ? rows : kTileRows;
  const int tiles = tile > 0 ? (rows + tile - 1) / tile : 0;
  return {tile, tiles < kStages ? tiles : kStages};
}

// Dynamic shared memory of a launch: the ring, or the partial results a
// cluster merges (R x threads of (t, slot)), whichever is larger: the
// merge reuses the ring once every tile has been tested.
inline int dynamic_smem_bytes(int R, int S, int threads, int n_rows) {
  const Ring ring = ring_of(n_rows, S);
  const int ring_bytes = ring.tile_rows * ring.stages * kRowBytes;
  const int merge_bytes = S > 1 ? 8 * R * threads : 0;
  return ring_bytes > merge_bytes ? ring_bytes : merge_bytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.  A copy
// that never lands is a fault, not a hang: the wait traps after about 10 s
// (2e10 cycles), which the launch's caller sees as an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

// Thread 0: arrive on `bar` expecting `bytes`, and copy `bytes` from global
// `src` to shared `dst` by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Tests the 8 slots of one row (slots slot0 .. slot0 + 7), each against the
// R rays, in slot order; a strictly smaller t takes the slot.
template <int R>
__device__ __forceinline__ void test_row(const float4* row, int slot0,
                                         const dpt::Ray (&ray)[R], float eps,
                                         float (&best_t)[R],
                                         int (&best_s)[R]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 a = row[4 * k + 0];  // v0x v0y v0z e1x
    const float4 b = row[4 * k + 1];  // e1y e1z e2x e2y
    const float4 c = row[4 * k + 2];  // e2z oid valid -
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float t;
      if (dpt::slot_test(a, b, c, ray[j], eps, t) && t < best_t[j]) {
        best_t[j] = t;
        best_s[j] = slot0 + k;
      }
    }
  }
}

// Block b of cluster rank q holds the rays (b / S) R T + j T + x (thread x,
// j < R, T threads) and scans the rows of slice q.  Rays past n_rays test
// the last ray, join every barrier and store nothing.
template <int R, int S>
__global__ void __launch_bounds__(kMaxThreads) intersect_nearest_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float4* __restrict__ tris, int n_rays, int n_rows, float eps,
    float* __restrict__ out_t, int* __restrict__ out_tri) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int T = static_cast<int>(blockDim.x);
  const int x = static_cast<int>(threadIdx.x);
  const int q = S > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int first = static_cast<int>(blockIdx.x / S) * R * T + x;

  dpt::Ray ray[R];
  float best_t[R];
  int best_s[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = min(first + j * T, n_rays - 1);
    ray[j] = {__ldg(origin + 3 * r + 0), __ldg(origin + 3 * r + 1),
              __ldg(origin + 3 * r + 2), __ldg(direction + 3 * r + 0),
              __ldg(direction + 3 * r + 1), __ldg(direction + 3 * r + 2),
              0.f, 0.f, 0.f};
    best_t[j] = kTMax;
    best_s[j] = -1;
  }

  const Ring rg = ring_of(n_rows, S);
  const int begin = q * n_rows / S;
  const int end = (q + 1) * n_rows / S;
  const int n_tiles = rg.tile_rows > 0
                          ? (end - begin + rg.tile_rows - 1) / rg.tile_rows
                          : 0;
  auto load_tile = [&](int i) {
    const int stage = i % rg.stages;
    const int row0 = begin + i * rg.tile_rows;
    const int rows = min(rg.tile_rows, end - row0);
    bulk_load(ring + stage * rg.tile_rows * kRowFloat4,
              tris + static_cast<size_t>(row0) * kRowFloat4,
              static_cast<uint32_t>(rows * kRowBytes), &full[stage]);
  };
  if (x == 0 && n_tiles > 0) {
    for (int s = 0; s < rg.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(rg.stages, n_tiles); ++i) load_tile(i);
  }
  __syncthreads();

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % rg.stages;
    mbar_wait(&full[stage], static_cast<uint32_t>((i / rg.stages) & 1));
    const float4* tile = ring + stage * rg.tile_rows * kRowFloat4;
    const int row0 = begin + i * rg.tile_rows;
    const int rows = min(rg.tile_rows, end - row0);
    for (int k = 0; k < rows; ++k) {
      test_row<R>(tile + k * kRowFloat4, 8 * (row0 + k), ray, eps, best_t,
                  best_s);
    }
    // Every thread is done with this stage before the copy engine refills
    // it (the generic-proxy reads ordered before the async-proxy writes).
    __syncthreads();
    if (x == 0 && i + rg.stages < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(i + rg.stages);
    }
  }

  if constexpr (S > 1) {
    // The loop's last __syncthreads ended every read of the ring, and
    // every copy into it has completed: ranks 1 .. S-1 put their partial
    // (t, slot) there, and rank 0 takes them in slice order, a strictly
    // smaller t only, so an equal t keeps the lower slice.
    cg::cluster_group cluster = cg::this_cluster();
    float* part_t = reinterpret_cast<float*>(ring);
    int* part_s = reinterpret_cast<int*>(part_t + R * T);
    if (q > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        part_t[j * T + x] = best_t[j];
        part_s[j * T + x] = best_s[j];
      }
    }
    cluster.sync();
    if (q == 0) {
      for (int p = 1; p < S; ++p) {
        const float* rt = cluster.map_shared_rank(part_t, p);
        const int* rs = cluster.map_shared_rank(part_s, p);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float t = rt[j * T + x];
          if (t < best_t[j]) {
            best_t[j] = t;
            best_s[j] = rs[j * T + x];
          }
        }
      }
    }
    // No block exits while rank 0 may still read its shared memory.
    cluster.sync();
    if (q > 0) return;
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = first + j * T;
    if (r < n_rays) {
      out_t[r] = best_t[j];
      out_tri[r] =
          best_s[j] < 0 ? 0 : static_cast<int>(__ldg(tris + 4 * best_s[j] + 2).y);
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float4*, int, int,
                          float, float*, int*);

// The instantiation of rays per thread R and cluster blocks S, or null.
KernelFn kernel_of(int R, int S) {
  switch (10 * R + S) {
    case 11: return intersect_nearest_kernel<1, 1>;
    case 12: return intersect_nearest_kernel<1, 2>;
    case 21: return intersect_nearest_kernel<2, 1>;
    case 22: return intersect_nearest_kernel<2, 2>;
    default: return nullptr;
  }
}

bool valid_threads(int threads) {
  return threads > 0 && threads <= kMaxThreads && threads % 32 == 0;
}

// The launch of `blocks` blocks of `threads` in clusters of S: `attr` is
// the cluster's dimension, attached for S > 1.
cudaLaunchConfig_t launch_config(int R, int S, int threads, int n_rows,
                                 int blocks, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = dynamic_smem_bytes(R, S, threads, n_rows);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  return cfg;
}

}  // namespace

// Launch on `stream` with R rays per thread, clusters of S blocks, `threads`
// per block and `blocks` blocks (ceil(n_rays / (R threads)) x S, which the
// wrapper computes): out_t gets the nearest t (1e30 on a miss), out_tri
// the triangle id (0 on a miss).  Returns cudaErrorInvalidValue for a
// geometry that is not built or a grid that does not cover the rays once,
// else the launch's error (a refused cluster or shared-memory request
// included), then cudaGetLastError().
extern "C" int dpt_intersect_nearest(const float* origin,
                                     const float* direction,
                                     const float* tris, int n_rays,
                                     int n_rows, float eps, float* out_t,
                                     int* out_tri, int R, int S, int threads,
                                     int blocks, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const KernelFn kernel = kernel_of(R, S);
  if (kernel == nullptr || !valid_threads(threads) || n_rows < 0 ||
      blocks % S != 0 ||
      blocks / S != (n_rays + R * threads - 1) / (R * threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(R, S, threads, n_rows, blocks,
                    static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, origin, direction,
                         reinterpret_cast<const float4*>(tris), n_rays, n_rows,
                         eps, out_t, out_tri);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Registers and local bytes per thread, resident blocks per SM, dynamic
// shared memory bytes and the clusters of S blocks the card can hold at
// once, of the kernel with R rays per thread and clusters of S blocks, at
// `threads` per block over a table of n_rows rows.
extern "C" int dpt_intersect_nearest_attrs(int R, int S, int threads,
                                           int n_rows, int* num_regs,
                                           int* local_bytes,
                                           int* blocks_per_sm,
                                           int* smem_bytes,
                                           int* max_clusters) {
  const KernelFn kernel = kernel_of(R, S);
  if (kernel == nullptr || !valid_threads(threads) || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = dynamic_smem_bytes(R, S, threads, n_rows);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(kernel), threads,
      static_cast<size_t>(*smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t cfg =
      launch_config(R, S, threads, n_rows, S, nullptr, &cluster);
  cfg.numAttrs = 1;  // a cluster of one block for S = 1
  err = cudaOccupancyMaxActiveClusters(
      max_clusters, reinterpret_cast<const void*>(kernel), &cfg);
  return static_cast<int>(err);
}

// Device helpers shared by the probes (the H100 forms of the TPU probes
// under scripts/): the interleaved pointer-chase chains P5 / P6
// (interleave.cu) and the walk-step variants P2 (interleave2.cu), whose
// step is a dependent record load, a slab pair, and the next index, and
// whose tile-wide ORs (P6, P2) are words exchanged over a thread-block
// cluster by st.async into mbarrier-counted slots; P1
// (smem_walk.cu) stages its records by bulk copies counted on an mbarrier
// and takes K1's helpers from traverse_common.cuh; the primitive
// probes P3, P4, P7 and P8 (crossbar.cu, features.cu) take the
// tile shape and JAX's dynamic-slice start.
//
// The chains' tables are the TPU probes' `nodes` [1024, 128] f32, read as
// 8192 records of 16 floats: the TPU probe loads row rid // 8 and rolls
// record rid % 8 to lanes 0-15 (`pltpu.roll(row, -(rid % 8) * 16)`), which
// on the card is one load of record rid.  Their rays are the [8, 128] ray
// tiles, one thread per element, the tile over one or several blocks.
#pragma once

#include <cstdint>

#include "../traverse_common.cuh"

namespace dpt {
namespace probe {

// The elements of one [8, 128] tile, one thread each.
constexpr int kTile = 1024;
// Records of 16 floats in the node table ([1024, 128] f32).
constexpr int kRecords = 8192;
// Warps over the tile, in every shape: one exchange slot each.
constexpr int kWarps = kTile / 32;
// Bytes each block of a cluster receives a step: the 32 warps' words.
constexpr uint32_t kStepBytes = 4 * kWarps;

// Python's (and jnp's) floor mod of an int32: CUDA's % truncates, and
// trunc(field) + rid may be negative.
__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

// The start of a dynamic slice of `size` along an axis of `dim`, as JAX
// indexes (`ref[i]`, `pl.ds(i, size)`): a negative i counts from the end,
// then the start is clamped into [0, dim - size] (lax.dynamic_slice).  The
// primitive probes read their indices on the device, so an index out of
// range is clamped here rather than refused by the host.
__device__ __forceinline__ int dyn_start(int i, int dim, int size) {
  const int s = i < 0 ? i + dim : i;
  return min(max(s, 0), dim - size);
}

// The probes' inverse direction 1 / where(|d| < 1e-20, 1e-20, d): unlike
// K1's safe_inv, a tiny negative component becomes +1e20.
__device__ __forceinline__ float probe_inv(float d) {
  return 1.0f / (fabsf(d) < kTiny ? kTiny : d);
}

// The ray of element `i` of chain p's six [8, 128] tiles
// (rays[p][0..5][1024]: ox oy oz dx dy dz).
__device__ __forceinline__ Ray load_tile_ray(const float* __restrict__ rays,
                                             int p, int i) {
  const float* r = rays + static_cast<size_t>(p) * 6 * kTile + i;
  Ray ray;
  ray.ox = __ldg(r + 0 * kTile);
  ray.oy = __ldg(r + 1 * kTile);
  ray.oz = __ldg(r + 2 * kTile);
  ray.dx = __ldg(r + 3 * kTile);
  ray.dy = __ldg(r + 4 * kTile);
  ray.dz = __ldg(r + 5 * kTile);
  ray.ix = probe_inv(ray.dx);
  ray.iy = probe_inv(ray.dy);
  ray.iz = probe_inv(ray.dz);
  return ray;
}

// Record `rid` (16 floats): the same address for every thread of the
// block, so each of the four 16-byte loads is one broadcast.
__device__ __forceinline__ void load_record(const float4* __restrict__ nodes,
                                            int rid, float (&f)[16]) {
  const float4* p = nodes + 4 * static_cast<size_t>(rid);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(p + q);
    f[4 * q + 0] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// The probes' `aabb` pair: the slabs of the boxes at fields 0-5 (left) and
// 6-11 (right), in the TPU probes' order (K1's slab test).
__device__ __forceinline__ void slab_pair(const float (&f)[16], const Ray& r,
                                          float& ltn, float& ltf, float& rtn,
                                          float& rtf) {
  slab(f, 0, r, ltn, ltf);
  slab(f, 6, r, rtn, rtf);
}

// The exchange of a tile-wide OR over a cluster (P6, P2): each step every
// warp sends one word into slot w (its warp of the tile) of every block's
// shared memory with st.async, which counts the word's 4 bytes into that
// block's mbarrier; a block waits on its own mbarrier for the step's
// kStepBytes and ORs its slots.  Slots and mbarriers are double-buffered
// by step parity.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// The one local arrival of the next phase of `bar`, expecting `bytes`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The one local arrival of the next phase of `bar`, expecting kStepBytes.
__device__ __forceinline__ void mbar_expect_step(uint64_t* bar) {
  mbar_expect(bar, kStepBytes);
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to this block's shared `dst` by the copy engine, completing
// `bytes` of the transaction of `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of `bar` with this parity has completed.  A word
// or copy that never lands is a fault, not a hang: the wait traps after about 10 s
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

// Stores v into block `rank`'s copy of *slot (st.async), completing 4 bytes
// of the transaction of its copy of *bar.
__device__ __forceinline__ void send_word(unsigned* slot, uint64_t* bar,
                                          int rank, unsigned v) {
  uint32_t rslot, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rslot)
               : "r"(smem_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rbar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];" ::"r"(rslot),
      "r"(v), "r"(rbar)
      : "memory");
}

}  // namespace probe
}  // namespace dpt

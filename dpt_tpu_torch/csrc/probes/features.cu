// P7 and P8 on Hopper: the Mosaic feature checks, each a kernel of a few
// loads and stores.
//
// Replaces the eight kernels of scripts/attic/probe_pallas.py (P7) and
// scripts/attic/probe_pallas2.py (P8), which asked whether Mosaic could
// lower what a packet-BVH kernel needs:
//   P7-1 probe_scalar_load_from_vmem :17  out[0, c] = table[i, c] * 2
//   P7-2 probe_scalar_extract :40         out[0, c] = table[i, 0]
//   P7-3 probe_smem_stack_while :63       a stack of 32 int32 in scratch,
//                                          popped / replaced while sp > 0;
//                                          out[0, c] = 11.0
//   P7-4 probe_int_vector_ops :104        out[r, c] = c even ? c : -c
//   P8-1 probe_dyn_lane_slice :18         out[r, c] = t[r, i]
//   P8-2 probe_dyn_roll :36               out[r, c] = t[r, b + (c + i % 128)
//                                          % 128], b = (i // 128) * 128
//   P8-3 probe_scalar_dyn_lane :55        out[0, c] = t[3, i]
//   P8-4 probe_dyn_sublane_row :73        out[0, c] = packed[i // 16,
//                                          (c + (i % 16) * 8) % 128]
// with i = idx[0], read on the device (the TPU probes hold it in SMEM; here
// the wrapper never brings it to the host).  An index out of range is
// treated as JAX treats it (`dyn_start`: negative from the end, then
// clamped), so the kernels never read out of bounds.
//
// Design: one block, one thread per output element (128 or 1024 threads).
// Every thread of a block reads the index at one address, and in P7-2 and
// P8-3 the one table word: each is one broadcast load.  P7-3 runs its loop
// in one thread over a stack in shared memory (volatile, so the loads and
// stores happen as written) and broadcasts the sum through shared memory.
// What bounds them: a few hundred bytes to 4 KB moved and no arithmetic to
// speak of, so each launch costs what any launch does; they are
// launch-bound on this card by construction.

#include "probe_common.cuh"

namespace {

using dpt::probe::dyn_start;
using dpt::probe::kTile;
constexpr int kLanes = 128;
constexpr int kStackWords = 32;

__global__ void __launch_bounds__(kLanes) scalar_load_kernel(
    const int* __restrict__ idx, const float* __restrict__ table, int n_rows,
    float* __restrict__ out) {
  const int c = static_cast<int>(threadIdx.x);
  const int r = dyn_start(__ldg(idx), n_rows, 1);
  out[c] = __ldg(table + static_cast<size_t>(r) * kLanes + c) * 2.0f;
}

__global__ void __launch_bounds__(kLanes) scalar_extract_kernel(
    const int* __restrict__ idx, const float* __restrict__ table, int n_rows,
    float* __restrict__ out) {
  const int r = dyn_start(__ldg(idx), n_rows, 1);
  out[threadIdx.x] = __ldg(table + static_cast<size_t>(r) * kLanes);
}

__global__ void __launch_bounds__(kLanes) smem_stack_kernel(
    float* __restrict__ out) {
  __shared__ int stack_words[kStackWords];
  __shared__ float result;
  if (threadIdx.x == 0) {
    volatile int* stack = stack_words;
    stack[0] = 7;
    stack[1] = 3;
    int sp = 2;
    float acc = 0.f;
    while (sp > 0) {
      const int top = stack[sp - 1];
      acc = acc + static_cast<float>(top);
      if (top == 3) {
        stack[sp - 1] = 1;  // replace the top, sp unchanged
      } else {
        sp = sp - 1;
      }
    }
    result = acc;
  }
  __syncthreads();
  out[threadIdx.x] = result;
}

__global__ void __launch_bounds__(kTile) int_vector_ops_kernel(
    int* __restrict__ out) {
  const int e = static_cast<int>(threadIdx.x);
  const int c = e % kLanes;
  out[e] = c % 2 == 0 ? c : -c;
}

__global__ void __launch_bounds__(kTile) dyn_lane_slice_kernel(
    const int* __restrict__ idx, const float* __restrict__ t, int n,
    float* __restrict__ out) {
  const int e = static_cast<int>(threadIdx.x);
  const int r = e / kLanes;
  out[e] = __ldg(t + static_cast<size_t>(r) * n + dyn_start(__ldg(idx), n, 1));
}

__global__ void __launch_bounds__(kTile) dyn_roll_kernel(
    const int* __restrict__ idx, const float* __restrict__ t, int n,
    float* __restrict__ out) {
  const int e = static_cast<int>(threadIdx.x);
  const int r = e / kLanes;
  const int c = e % kLanes;
  const int i = __ldg(idx);
  // floor(i / 128) * 128 and floor_mod(i, 128), as jnp's // and %
  const int base = dyn_start((i >> 7) * kLanes, n, kLanes);
  const int shift = i & (kLanes - 1);
  out[e] = __ldg(t + static_cast<size_t>(r) * n + base
                 + ((c + shift) & (kLanes - 1)));
}

__global__ void __launch_bounds__(kLanes) scalar_dyn_lane_kernel(
    const int* __restrict__ idx, const float* __restrict__ t, int n,
    float* __restrict__ out) {
  out[threadIdx.x] = __ldg(t + 3 * static_cast<size_t>(n)
                           + dyn_start(__ldg(idx), n, 1));
}

__global__ void __launch_bounds__(kLanes) dyn_sublane_row_kernel(
    const int* __restrict__ idx, const float* __restrict__ packed, int m,
    float* __restrict__ out) {
  const int c = static_cast<int>(threadIdx.x);
  const int i = __ldg(idx);
  const int row = dyn_start(i >> 4, m, 1);  // floor(i / 16)
  const int shift = (i & 15) * 8;           // floor_mod(i, 16) * 8
  out[c] = __ldg(packed + static_cast<size_t>(row) * kLanes
                 + ((c + shift) & (kLanes - 1)));
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each launch runs on `stream` and returns cudaGetLastError() after it.
// idx is one int32 on the device; tables are row-major float32: P7-1 / P7-2
// table [dim, 128], P8-1..3 t [8, dim], P8-4 packed [dim, 128] (P8-2 needs
// dim >= 128, the others dim >= 1; the wrappers check).  Outputs: [1, 128]
// f32, except P8-1 / P8-2 [8, 128] f32 and P7-4 [8, 128] int32.
extern "C" int dpt_probe_scalar_load(const int* idx, const float* table,
                                     int dim, float* out, void* stream) {
  scalar_load_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, table, dim, out);
  return last_error();
}

extern "C" int dpt_probe_scalar_extract(const int* idx, const float* table,
                                        int dim, float* out, void* stream) {
  scalar_extract_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, table, dim, out);
  return last_error();
}

extern "C" int dpt_probe_smem_stack(float* out, void* stream) {
  smem_stack_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return last_error();
}

extern "C" int dpt_probe_int_vector_ops(int* out, void* stream) {
  int_vector_ops_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      out);
  return last_error();
}

extern "C" int dpt_probe_dyn_lane_slice(const int* idx, const float* t,
                                        int dim, float* out, void* stream) {
  dyn_lane_slice_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, t, dim, out);
  return last_error();
}

extern "C" int dpt_probe_dyn_roll(const int* idx, const float* t, int dim,
                                  float* out, void* stream) {
  dyn_roll_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, t, dim, out);
  return last_error();
}

extern "C" int dpt_probe_scalar_dyn_lane(const int* idx, const float* t,
                                         int dim, float* out, void* stream) {
  scalar_dyn_lane_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, t, dim, out);
  return last_error();
}

extern "C" int dpt_probe_dyn_sublane_row(const int* idx, const float* packed,
                                         int dim, float* out, void* stream) {
  dyn_sublane_row_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, packed, dim, out);
  return last_error();
}

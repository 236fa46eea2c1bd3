// P2 on Hopper: the walk-step variants A-D, P chains interleaved in one
// block, each with a stack of 32 indices shared by the whole tile.
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
// of the stack (stack[max(sp - 1, 0)]; A: stack[0]) and the block's count
// of mt8 slot tests with ok true.  It keeps nvcc from deleting work whose
// output is otherwise constant, and the plain version computes the same.
//
// Design: one block of 1024 threads computes the tile, one thread per
// element, P chains unrolled in registers.  lhit and rhit are block-wide
// ORs (__syncthreads_or), so rid, sp and the stack are the same in every
// thread.  The stacks are in shared memory: every thread writes the same
// value to the same word, and no extra barrier is needed, because the
// writes follow the step's last barrier and the next step's reads precede
// its first.  (A per-thread stack in local memory, a runtime-indexed array
// as K1's, was timed against it on the H100 and was slower at P = 8, where
// it spills: PERF.md.)  One block runs on one SM, so one SM's issue rate
// for the step's float work and mt8's bounds it from below, with each
// step's dependent load and its barriers; against the whole card its bound
// is a tiny share by construction.
// Built with -fmad=false: the plain version (probes/probe_interleave2.py)
// gives the same values bit for bit.

#include "probe_common.cuh"

namespace {

using dpt::probe::kRecords;
using dpt::probe::kTile;

constexpr int kStackWords = 32;
constexpr int kTriRows = 512;

// Adds `v` of every thread into *total (a shared counter set to 0 before a
// barrier) and returns the sum after the block's barrier.
__device__ __forceinline__ int block_sum(int v, int* total) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(total, v);
  __syncthreads();
  return *total;
}

// The probe's Möller–Trumbore over the 8 slots of leaf row `tr` (8 x 16
// floats: v0 at 0-2, e1 at 3-5, e2 at 6-8); counts each ok slot in *n_ok.
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

// V: 0 = A, 1 = B, 2 = C, 3 = D.
template <int P, int V>
__global__ void __launch_bounds__(kTile) interleave2_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const float* __restrict__ rays, int iters, float* __restrict__ out,
    int* __restrict__ sink) {
  __shared__ int stack[P][kStackWords];
  __shared__ int n_ok_total[P];
  const int i = static_cast<int>(threadIdx.x);
  dpt::Ray ray[P];
  float acc[P];
  int sp[P], n_ok[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ray[p] = dpt::probe::load_tile_ray(rays, p, i);
    acc[p] = 0.f;
    sp[p] = 1;
    n_ok[p] = 0;
    stack[p][0] = 7 * p + 1;
    if (i == 0) n_ok_total[p] = 0;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int spm = max(sp[p] - 1, 0);
      const int rid = stack[p][V == 0 ? 0 : spm];
      float f[16];
      dpt::probe::load_record(nodes, rid, f);
      float ltn, ltf, rtn, rtf;
      dpt::probe::slab_pair(f, ray[p], ltn, ltf, rtn, rtf);
      const bool lhit = dpt::probe::block_any(ltn <= ltf && ltf >= 0.f);
      const int lptr =
          dpt::probe::floor_mod(static_cast<int>(f[12]) + rid, kRecords);
      const int rptr =
          dpt::probe::floor_mod(static_cast<int>(f[13]) + rid, kRecords);
      if constexpr (V == 0) {
        acc[p] = acc[p] + (ltn <= ltf ? ltn : rtn);
        stack[p][0] = lhit ? lptr : rptr;
      } else {
        const bool rhit = dpt::probe::block_any(rtn <= rtf && rtf >= 0.f);
        const float4* tr = tris + 32 * (rid % kTriRows);
        if constexpr (V == 2) {
          if (f[14] > 0.f && lhit) acc[p] = mt8(tr, ray[p], acc[p], n_ok[p]);
        } else if constexpr (V == 3) {
          acc[p] = mt8(tr, ray[p], acc[p], n_ok[p]);
        }
        if (lhit && rhit) {
          stack[p][spm] = lptr;
          stack[p][spm + 1] = rptr;
        } else if (lhit != rhit) {
          stack[p][spm] = lhit ? lptr : rptr;
        }
        sp[p] = max(min(spm + (lhit ? 1 : 0) + (rhit ? 1 : 0), 30), 1);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[p * kTile + i] = acc[p];
    const int top = stack[p][V == 0 ? 0 : max(sp[p] - 1, 0)];
    const int total = block_sum(n_ok[p], &n_ok_total[p]);
    if (i == 0) {
      sink[3 * p + 0] = sp[p];
      sink[3 * p + 1] = top;
      sink[3 * p + 2] = total;
    }
  }
}

template <int P, int V>
int launch_v(const float4* n4, const float4* t4, const float* rays,
             int iters, float* out, int* sink, cudaStream_t s) {
  interleave2_kernel<P, V><<<1, kTile, 0, s>>>(n4, t4, rays, iters, out,
                                               sink);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(const float4* n4, const float4* t4, const float* rays,
             int variant, int iters, float* out, int* sink, cudaStream_t s) {
  switch (variant) {
    case 0: return launch_v<P, 0>(n4, t4, rays, iters, out, sink, s);
    case 1: return launch_v<P, 1>(n4, t4, rays, iters, out, sink, s);
    case 2: return launch_v<P, 2>(n4, t4, rays, iters, out, sink, s);
    case 3: return launch_v<P, 3>(n4, t4, rays, iters, out, sink, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch on `stream`: nodes [8192 x 16] f32 and tris [512 x 128] f32
// (both 16-byte aligned), rays [P][6][1024] f32, out [P][1024] f32, sink
// [P][3] int32.  `variant` 0-3 is A-D.  P is 1 or 8 (the TPU probe's);
// another P or variant returns cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
extern "C" int dpt_probe_interleave2(const float* nodes, const float* tris,
                                     const float* rays, int P, int variant,
                                     int iters, float* out, int* sink,
                                     void* stream) {
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1:
      return launch_p<1>(n4, t4, rays, variant, iters, out, sink, s);
    case 8:
      return launch_p<8>(n4, t4, rays, variant, iters, out, sink, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

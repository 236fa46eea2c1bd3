// P5 and P6 on Hopper: P independent pointer-chase chains interleaved in
// one block, each step a dependent record load and a slab pair.
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
// so the reduction sits on the chain of dependent loads; on the card it is
// a barrier of the block (__syncthreads_or).
//
// Design: one block of 1024 threads computes the tile, one thread per
// element, and each thread runs the P chains in registers, unrolled, so P
// record loads are in flight at once.  The chain index depends on the
// table alone (and on the block-wide any), so it is the same in every
// thread and each record load is one broadcast.  What bounds it: one block
// runs on one SM, and its 1024 threads do ~51 float operations each a step
// and chain, so one SM's share of the card's issue rate bounds the step
// from below (the whole card's bound is a tiny share by construction);
// with 32 warps a block, each step's dependent load (and, in P6, the
// barrier) waits behind the other warps' work, not alone.  The output also
// carries a sink per chain (0, the final index, 0), the layout P2 shares.
// Built with -fmad=false: the plain PyTorch version
// (probes/probe_interleave.py) gives the same values bit for bit.

#include "probe_common.cuh"

namespace {

using dpt::probe::kRecords;
using dpt::probe::kTile;

template <int P, bool kAny>
__global__ void __launch_bounds__(kTile) interleave_kernel(
    const float4* __restrict__ nodes, const float* __restrict__ rays,
    int iters, float* __restrict__ out, int* __restrict__ sink) {
  const int i = static_cast<int>(threadIdx.x);
  dpt::Ray ray[P];
  float acc[P];
  int rid[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ray[p] = dpt::probe::load_tile_ray(rays, p, i);
    acc[p] = 0.f;
    rid[p] = 7 * p + 1;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float f[16];
      dpt::probe::load_record(nodes, rid[p], f);
      float ltn, ltf, rtn, rtf;
      dpt::probe::slab_pair(f, ray[p], ltn, ltf, rtn, rtf);
      const bool hit = ltn <= ltf && ltf >= 0.f;
      acc[p] = acc[p] + (hit ? ltn : rtn);
      int nxt = static_cast<int>(f[12]) + rid[p];
      if (kAny) nxt += dpt::probe::block_any(hit) ? 1 : 0;
      rid[p] = dpt::probe::floor_mod(nxt, kRecords);
    }
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
}

template <int P>
int launch_p(const float* nodes, const float* rays, int iters, int any,
             float* out, int* sink, cudaStream_t s) {
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  if (any) {
    interleave_kernel<P, true><<<1, kTile, 0, s>>>(n4, rays, iters, out, sink);
  } else {
    interleave_kernel<P, false><<<1, kTile, 0, s>>>(n4, rays, iters, out, sink);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream`: nodes [8192 x 16] f32 (16-byte aligned), rays
// [P][6][1024] f32, out [P][1024] f32, sink [P][3] int32.  `any` selects
// P6 (the tile's any(hit) in the next index).  P is 1, 2, 4 or 8; another
// P returns cudaErrorInvalidValue.  Returns cudaGetLastError() after the
// launch.
extern "C" int dpt_probe_interleave(const float* nodes, const float* rays,
                                    int P, int iters, int any, float* out,
                                    int* sink, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch_p<1>(nodes, rays, iters, any, out, sink, s);
    case 2: return launch_p<2>(nodes, rays, iters, any, out, sink, s);
    case 4: return launch_p<4>(nodes, rays, iters, any, out, sink, s);
    case 8: return launch_p<8>(nodes, rays, iters, any, out, sink, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The probe library's error strings, under the render library's name
// (each library is loaded on its own).
extern "C" const char* dpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

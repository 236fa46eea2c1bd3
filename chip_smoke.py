"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python chip_smoke.py

Drives `dpt_tpu_torch` only (no JAX, no `dpt_tpu`), in 23 phases, each
printing one line or more:

  1. device   — a CUDA card of compute capability 9.0; prints
                `nvidia-smi --query-gpu=name,power.limit`.
  2. build    — compiles the kernels from csrc/ (one nvcc per source, all
                at once) and prints the build time and each kernel's
                registers, local bytes per thread and resident blocks per
                SM (K3's also its dynamic shared memory, at the geometry of
                each phase-9 stream).
  3. K1       — csrc/quad_traverse.cu against its plain PyTorch walk on the
                card, at the flagship tables (65,024 triangles, SAH leaf 8,
                packed 4-wide), on the 1024² primary stream, on 2**18
                incoherent, coherence-sorted rays and on 126,621 of them
                (the size of the render's later queries), in both designs
                (one ray per lane, one per group of four lanes): hit /
                occluded / tri exact and t equal.  Median ms over 5 calls
                with varied inputs, CUDA events, after a warm-up (the
                wrapper as the render calls it, in the design it picks),
                and the kernel's own device time from torch.profiler in
                that design and in each; the bound from the node visits and
                triangle tests these inputs need; the lane utilisation of a
                one-ray-per-lane warp from the plain walk's per-ray visits.
  4. K2       — csrc/wide_traverse.cu the same way (one design, one ray per
                lane), at the same tree packed paired-children
                (`traversal="pallas"`).
  5. render   — the flagship forward render through the CLI (sylveon512 at
                1024², 4 batches); the image must be finite, >= 0 and not
                all zero, the PNG valid, and K1 launched 16 nearest + 16
                occluded times per batch, the 31 launches of each batch
                after its primary query in groups of four lanes.
  6. devices  — the same config at 64² on the card (kernel) and on the CPU
                (plain walk), allclose at rtol 1e-3, atol 2e-3.
  7. optimize — inverse rendering through the CLI at 1024²: a target
                rendered with `render --out target.npy`, then 3 tape-backward
                steps from albedo 0.4, first with `quad` (albedo and
                vertices, refit every step), then with `pallas` (albedo and
                light intensity).  Finite losses, the albedo moves toward
                the target's (quad) and the loss falls (pallas); each taped
                forward launches the walk 1 + 15 (nearest) and 16
                (occluded) times for each chunk of the static capacity its
                tape ran (the vertices grow the sphere past one chunk), and
                no backward launches it; refit_quad with unchanged vertices
                is pack_quad bit for bit.  Prints step_ms and peak device
                memory.
  8. grads    — tape_loss_and_grads at 64² on the card (kernels) against
                the CPU (plain walks), quad and pallas: loss at rtol 1e-5,
                every gradient at rtol 1e-3 / atol 1e-4 x max|g| (the CPU
                tests' tolerance).
  9. K3       — csrc/intersect_nearest.cu against its plain PyTorch version
                on the card: box512's 512² primary stream over the box (12
                triangles), its compacted chunk (2**16 rays leaving the
                box) and 2**16 incoherent rays over the procedural sphere
                of 3,720 triangles; hit, tri and t exact through the
                wrapper and in every geometry (rays per thread x blocks per
                cluster x threads per block, forced through `_launch`).
                Median ms over 5 calls with varied inputs, the kernel's
                device ms at the geometry the wrapper picks, its share of
                the bound, registers, dynamic shared memory and blocks per
                SM.
 10. box      — the box-scale path: `render_progressive` at box512 with
                kernels="intersect" (512², 4 bounces, SSS, Russian roulette,
                16 spp per batch), 4 batches through a camera source with a
                checkpoint every 2 batches.  The image is finite, >= 0 and
                not all zero; K3 is launched the integrator's count of
                nearest queries (16 per sub-sample) per batch; a resume from
                the batch-2 checkpoint and a camera change followed by 4
                batches both give the image bit for bit; kernels="intersect"
                against "none" on the card at rtol 1e-4 / atol 1e-5, and
                the card against the CPU at 32² at rtol 1e-3 / atol 2e-3.
 11. cli      — `render --checkpoint` of the flagship for 2 batches, then
                for 4 with the same file and `--compact-frac auto` (prints
                "resuming from batch 2" and the derived fraction); a
                scripted `interactive` session at box512 (orbit, render 2,
                save, status, quit); `info`.
 12. sharded render — two ranks on the one card (gloo, by the backend rule)
                run `render --sharded --num-processes 2 --process-id N
                --coordinator localhost:PORT` on the flagship (2 batches);
                rank 0's image equals the single process's at rtol 1e-5,
                atol 1e-6; each rank launched K1; the backend and batch_ms
                of each rank.
 13. sharded optimize — two ranks take 2 tape steps at 1024² (quad,
                albedo) through `optimize --sharded`; rank 0's albedo
                equals the single process's at rtol 1e-5, atol 1e-7; only
                rank 0 writes its checkpoint, and a rerun to 3 steps
                resumes at step 2 on both ranks (rank 1 has no file).
 14. lbvh     — the flagship's LBVH built on the card is the CPU build byte
                for byte, and so are prune_bvh + pack_quad of it; K1 over
                it equals the plain walk exactly (1024² primary stream,
                126,621 incoherent rays); one `render --bvh-builder lbvh`
                batch launches K1 16 + 16 times; the card's build ms beside
                the CPU's and the host SAH build's.
 15. wavefront — a flagship batch with wavefront_sort equals the batch
                without it bit for bit and launches K1 16 + 16 times; batch
                ms of each.
 16. walks    — `bvh`, `packet` and `threaded` (the per-ray walk in torch
                ops) render box512 at 64² on the card, allclose to brute at
                rtol 1e-3, atol 2e-3.
 17. native   — the host runtime built by g++ (csrc/native_host.cpp): the
                flagship's SAH and median trees (leaf 8) and the OBJ parse
                of its mesh are the numpy builders' and the Python parser's
                byte for byte, the native path is taken (its call counts),
                and each is timed beside its numpy version.  Phase 5 also
                asserts that the render's SAH build was native.
 18. capacity — the static-capacity compaction: the flagship at
                compact_frac 0.125 (one live chunk of 131,072 lanes) and
                0.0625 (two live chunks of 65,536), box512 at its 0.25 at
                its own framing (one live chunk) and at radius 2.5 with 4
                spp (every lane live: four chunks), each image equal to the
                same render at compact_frac 0 bit for bit; K1 launched 16 +
                16 and 31 + 32 times per batch; batch ms of each.
 19. syncs    — one flagship render_sample under
                torch.cuda.set_sync_debug_mode("warn") at compact_frac
                0.125 and at 0, the synchronising calls counted by
                file:line; the compacted batch may not have more.
 20. probes   — the walk probes (dpt_tpu_torch/probes/, csrc/probes/,
                built at first use into their own library): P5 and P6
                (interleave.cu) at P = 1, 2, 4, 8, through `make` and once
                more reading the SM of each block (P5: 32 blocks of 32; P6:
                one cluster of 8 blocks of 128), and P2 (interleave2.cu)
                A-D at P = 1 and 8 through `make` and once more in its
                one shape reading the SM of each block (one cluster of 8
                blocks of 128), 64 steps, equal to their plain
                versions on the card bit for bit, tiles and sink; P5 / P6
                print each launch's grid, block, cluster and warps on the
                busiest SM with its kernel time, P2 the same for each
                variant and P, what B, C and D add over A and B, and the
                latency floor; P1 (smem_walk.cu) in every mode
                (`r3_smem_proto.modes`: 0 and the end of every BFS level,
                the last the whole table; blocks of 128 and 1024 threads
                where one block holds the prefix, else 1024 in the
                smallest cluster that does, the top 341 records in every
                block and the rest interleaved) on two 126,621-ray
                flagship streams equal to K1's lane kernel and the plain
                walk bit for bit, and P1's leaf-test reciprocal equal to
                1.0f / x on every float32 of its input range (|x| >=
                1e-6, both signs).  Each probe is run once through
                its public function with the launch counts set to 0 before
                and read after; one timing line each (wrapper, kernel,
                plain and bound; P1 per mode beside K1 lane, with blocks
                per SM and clusters at once).  The probes' launch counts are
                set to 0 before phase 3 and read before phase 20: the
                render, optimize and walk phases may launch no probe.
 21. primitives — the primitive probes (the same library): P3
                and P4 (crossbar.cu, B at K = 1, 4, 12), P7 and P8
                (features.cu), each launched once through its public
                function at the TPU scripts' inputs and steps (the launch
                counts set to 0 before and read after) and equal to its
                plain version bit for bit; the TPU scripts' own checks of
                P7 and P8 (P8 at i = 0, 127, 128, 200, 511); the card's
                clocks a dependent operation, read by a bare chain of
                multiply-adds in one warp (equal to its plain version bit
                for bit), and P4-e's first warp alone on one SM with its
                own clocks an operation; the step loops of P4-a, P4-d
                and P3-b in the probe library's machine code (cuobjdump):
                one shared load a step for P4-a, no global load and a
                bulk copy a step for P4-d, one shared load a lookup and
                no global load for P3-b; then one timing line each
                (wrapper, kernel, plain, the library call where one
                computes the same function, the bound, for the loops ns a
                step beside the bound of one SM, and for each loop its
                chain's latency bound at the card's clocks, P4-e's own
                beside them).
 22. bench    — `dpt_tpu_torch.bench.main` in this process at full width:
                the flagship default (1024², 65,024 triangles, 4
                iterations), `--grad --iters 2` (tape), `--grad
                --grad-replay --iters 1` and `--scene-family knot --iters
                2`, each with K1's counts set to 0 before and read after;
                each JSON line printed as it is, then K1's launches, the
                peak device memory and the wall time; then `python -m
                dpt_tpu_torch.bench --quick` in a process of its own.  A
                run fails on a missing key, a value not finite or not above
                0, a kernel_mode that does not name the CUDA build, no K1
                launch, or live_in_by_depth[0] != 1.0.
 23. oracle   — the card's renders against the port's scalar oracle
                (dpt_tpu_torch/oracle/scalar.py) at rtol 1e-3 / atol 2e-3:
                K1 (`quad`, sylveon512's recipe) on a 300-triangle target
                of the sphere (224 triangles) at 12², K3 (`brute`,
                kernels="intersect", box512's recipe) on the box at 12²,
                each kernel's launches counted; then `validate_bvh` on the
                flagship's LBVH built on the card (leaf 1, and leaf 8
                pruned) and its SAH tree.

Then one JSON line with the kernels (each with its design; for K1 and K2
the primary stream's numbers, the other streams' under "_incoherent" and
"_bounce"; K1 with the launches of phase 22 as "launches_bench" and K1
and K3 with those of phase 23 as "launches_oracle"; the probes with the
launches of phase 20's or 21's run and, as
"launches_main_path", those of phases 3-19; each primitive probe with its
CUDA function's `source_line`), and as the last line
`{"ok": true, "device": {...}}`.  Any failed phase raises, and the script
exits non-zero without that last line.  Without a CUDA card it exits
non-zero at phase 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Full float32 everywhere: no TF32 in matrix products or convolutions (the
# port uses neither today; this keeps any later use exact-comparable).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# bench.py's default --tris: the procedural sphere then has 65,024 triangles.
FLAGSHIP_TRIS_TARGET = 66_000
FLAGSHIP_TRIS = 65_024
INCOHERENT_RAYS = 1 << 18
# The live rays of each flagship query after the primary: the primary hits
# of a 1024² batch (12.08% of the pixels), which compaction gathers into
# its static capacity of 131,072 lanes (compact_frac 0.125).
BOUNCE_RAYS = 126_621
TIMED_CALLS = 5
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and non-tensor-core float32 FLOP/s.  The float32 peak counts an
# FMA as two operations; the walks are built with -fmad=false and issue no
# FMA, so each of their operations takes a whole instruction slot and they
# run at most at half the peak: 33.5e12 operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_F32_UNFUSED_OPS_PER_S = PEAK_F32_FLOP_PER_S / 2
# Float operations of one slab test (6 sub, 6 mul, 10 min/max, 3 compares)
# and of one Möller–Trumbore test (54: two cross products, four dot
# products, the determinant test, one reciprocal, seven compares), as the
# kernels spell them out (csrc/traverse_common.cuh).  Each is counted at
# the add / mul rate, which min / max, compares and the reciprocal do not
# exceed, so the bound stays a least time.
FLOPS_PER_SLAB = 25
FLOPS_PER_TRI_TEST = 54
# kernel -> (source, the TPU kernel it replaces, slabs per record visited)
KERNELS = {
    "quad_traverse": ("dpt_tpu_torch/csrc/quad_traverse.cu",
                      "dpt_tpu/kernels/pallas_quad.py:511", 4),
    "wide_traverse": ("dpt_tpu_torch/csrc/wide_traverse.cu",
                      "dpt_tpu/kernels/pallas_wide.py:209", 2),
    "intersect_nearest": ("dpt_tpu_torch/csrc/intersect_nearest.cu",
                          "dpt_tpu/kernels/pallas_intersect.py:42", 0),
    # The walk probes (phase 20): P1 walks K1's tables, 4 slabs a record;
    # P5, P6 and P2 take a slab pair a step.
    "smem_walk": ("dpt_tpu_torch/csrc/probes/smem_walk.cu",
                  "scripts/r3_smem_proto.py:34", 4),
    "interleave": ("dpt_tpu_torch/csrc/probes/interleave.cu",
                   "scripts/probe_interleave.py:34", 2),
    "interleave_any": ("dpt_tpu_torch/csrc/probes/interleave.cu",
                       "scripts/attic/probe_interleave_any.py:34", 2),
    "interleave2": ("dpt_tpu_torch/csrc/probes/interleave2.cu",
                    "scripts/attic/probe_interleave2.py:55", 2),
    # The primitive probes (phase 21): no slab.
    **{name: (f"dpt_tpu_torch/csrc/probes/{src}.cu", f"scripts/{script}", 0)
       for name, src, script in (
           ("gather_axis1", "crossbar", "attic/probe_gather.py:66"),
           ("gather_axis0", "crossbar", "attic/probe_gather.py:98"),
           ("crossbar_sublane", "crossbar", "probe_crossbar.py:48"),
           ("crossbar_lanes", "crossbar", "probe_crossbar.py:64"),
           ("crossbar_fused", "crossbar", "probe_crossbar.py:80"),
           ("crossbar_rows", "crossbar", "probe_crossbar.py:101"),
           ("crossbar_math", "crossbar", "probe_crossbar.py:127"),
           ("scalar_load", "features", "attic/probe_pallas.py:17"),
           ("scalar_extract", "features", "attic/probe_pallas.py:40"),
           ("smem_stack", "features", "attic/probe_pallas.py:63"),
           ("int_vector_ops", "features", "attic/probe_pallas.py:104"),
           ("dyn_lane_slice", "features", "attic/probe_pallas2.py:18"),
           ("dyn_roll", "features", "attic/probe_pallas2.py:36"),
           ("scalar_dyn_lane", "features", "attic/probe_pallas2.py:55"),
           ("dyn_sublane_row", "features", "attic/probe_pallas2.py:73"))},
}
# The CUDA kernel function of each primitive probe (its line in the source
# goes into the kernels line as source_line).
PRIMITIVE_FUNCTIONS = {
    "gather_axis1": "lanes_kernel", "gather_axis0": "column_kernel",
    "crossbar_sublane": "sublane_kernel", "crossbar_lanes": "lanes_kernel",
    "crossbar_fused": "fused_kernel", "crossbar_rows": "rows_kernel",
    "crossbar_math": "math_kernel", "scalar_load": "scalar_load_kernel",
    "scalar_extract": "scalar_extract_kernel",
    "smem_stack": "smem_stack_kernel", "int_vector_ops": "int_vector_ops_kernel",
    "dyn_lane_slice": "dyn_lane_slice_kernel", "dyn_roll": "dyn_roll_kernel",
    "scalar_dyn_lane": "scalar_dyn_lane_kernel",
    "dyn_sublane_row": "dyn_sublane_row_kernel",
}
# kernel -> its design on the card, for the kernels line.
DESIGNS = {
    "quad_traverse": (
        "one ray per group of 4 lanes (a child's slab and 2 leaf slots "
        "each) up to kernels/quad.py GROUP_MAX_RAYS rays, one ray per lane "
        "above; one-instruction NaN min/max, leaf loads a slot ahead, "
        "near child taken without a push; per-lane stack in local memory"),
    "wide_traverse": (
        "one ray per lane; one-instruction NaN min/max, leaf loads a slot "
        "ahead, near child taken without a push; per-lane stack in local "
        "memory"),
    "intersect_nearest": (
        "R rays per thread (1 or 2), the table's rows split over a "
        "cluster of S blocks (1 or 2, merged by rank 0 through "
        "distributed shared memory), tiles of 16 rows bulk-copied into a "
        "3-stage shared-memory ring; the geometry picked per stream by "
        "kernels/intersect.py _geometry"),
    "smem_walk": (
        "K1's lane walk (nearest); the first n_staged records (whole BFS "
        "levels, up to the whole table) bulk-copied into shared memory at "
        "block start, in one block of 128 or 1024 threads or over a cluster "
        "of 2-8 blocks of 1024 (the top 341 records in each, the rest "
        "interleaved, remote ones read through distributed shared memory); "
        "the rest and the leaf rows from global memory; a leaf test with "
        "no call site (MUFU.RCP and one Newton step, the IEEE division "
        "redone only past 2^126 by a warp vote)"),
    "interleave": (
        "32 blocks of one warp, one thread per tile element, each block "
        "recomputing the table-only chain index; P chains unrolled in "
        "registers, each step a broadcast record load and a slab pair"),
    "interleave_any": (
        "the tile over one cluster of 8 blocks of 128 threads; the tile's "
        "any(hit) in the next index: a warp vote, each warp's word sent by st.async into every "
        "block's shared memory, one mbarrier wait a step for all P chains, "
        "double-buffered by step parity"),
    "interleave2": (
        "the tile over one cluster of 8 blocks of 128 threads; P chains "
        "unrolled, lhit / rhit as one word a warp and step sent by st.async "
        "into every block's shared memory, one mbarrier wait a step for all "
        "P chains, double-buffered by step parity; each warp's copy of the "
        "stacks in shared memory; A's and D's work issued while the words "
        "travel; a sink [P, 3] of final sp, top and the mt8 ok count summed "
        "into rank 0 through distributed shared memory"),
    "gather_axis1": (
        "P4-b's kernel at K = 1 (lanes_kernel<1>): 8 blocks of 128 "
        "threads, a tile row each, one thread per tile element; the row "
        "copied once a shared-memory bank (and its first 31 words again: "
        "one wavefront a lookup), a group of 32 steps read from one base, "
        "each lookup of the next group loaded beside an add of this one, "
        "the sum in the order of k"),
    "crossbar_sublane": (
        "32 blocks of one warp, one thread per tile element; each block's "
        "32 columns of x's 8 rows in shared memory (lane l's word of row j "
        "at j * 32 + l, always bank l); B and C's step loop, one volatile "
        "shared load a step, 8 steps' lookups in flight beside the adds, "
        "the sum in the order of k"),
    "crossbar_fused": (
        "32 blocks of one warp, one thread per tile element; all of x "
        "copied once a shared-memory bank (128 KB dynamic: lane l reads "
        "word w at w * 32 + l, always bank l, one wavefront a lookup), the "
        "block's 32 columns of the lane table plain (bank l already); two "
        "shared loads a step (the lane table's volatile), 8 steps' lookups "
        "in flight, each loaded beside an add of the 8 before, the sum in "
        "the order of k"),
    "gather_axis0": (
        "256 blocks of one warp, one thread per tile element; each block's "
        "32 columns of the 64 rows in shared memory (lane t's word of row "
        "j at j * 32 + t, always bank t, and the first 31 rows again), a "
        "group of 32 steps read from one base (an add, a mask and a shift "
        "a group), each lookup of the next group loaded beside an add of "
        "this one, the sum in the order of k"),
    "crossbar_lanes": (
        "8 blocks of 128 threads, a tile row each, one thread per tile "
        "element; the row of each of the K tiles x + q copied once a "
        "shared-memory bank (K x 16 KB dynamic, and the row's first U - 1 "
        "words again: one wavefront a lookup), K loads a step from K "
        "tiles, a group of U = 32 / K steps (1 at K = 12) read from one "
        "base, each lookup of the next group loaded beside an add of this "
        "one; K a template argument"),
    "crossbar_rows": (
        "32 blocks of one warp, 32 columns of a tile row each; the 2 MB "
        "table in device memory and L2, each step's 128-byte slice "
        "bulk-copied (cp.async.bulk from one elected lane) into a "
        "shared-memory ring of 8 stages of 16 steps (an mbarrier a stage, "
        "128 steps ahead, 16 KB), the slices' addresses computed a chunk "
        "ahead: no global load in the step loop"),
    "crossbar_math": (
        "32 blocks of one warp, one thread per tile element, v in a "
        "register, 141 dependent operations a step (-fmad=false): the "
        "chain's latency binds, not an SM's issue"),
    **dict.fromkeys(("scalar_load", "scalar_extract", "scalar_dyn_lane",
                     "dyn_sublane_row"), (
        "one block of 128 threads, one per output lane; the device-side index "
        "and the table word each one broadcast load")),
    **dict.fromkeys(("dyn_lane_slice", "dyn_roll", "int_vector_ops"), (
        "one block of 1024 threads, one per output element")),
    "smem_stack": (
        "one block of 128 threads; thread 0 walks a volatile stack in shared "
        "memory and broadcasts the sum through shared memory"),
}
# The probes' steps at the checks of phase 20 (P5, P6, P2; their mains take
# 512) and phase 21 (the primitive probes' loops; their mains take the TPU
# scripts' 100 to 2,000).
PROBE_ITERS = 64
# The K3 stream of real table size: the procedural sphere of 3,720
# triangles (465 table rows).
K3_TRIS_TARGET = 4000
K3_TRIS = 3720
K3_INCOHERENT_RAYS = 1 << 16
# box512's compacted chunk: compact_frac 0.25 of its 512² lanes, the
# stream of 240 of the 256 K3 launches of a 16-spp batch.
K3_BOUNCE_RAYS = 1 << 16
# Phase 9's streams: (rays, table rows).  The box's 12 triangles fill 2
# rows.
K3_STREAMS = {"primary": (512 * 512, 2),
              "incoherent": (K3_INCOHERENT_RAYS, K3_TRIS // 8),
              "bounce": (K3_BOUNCE_RAYS, 2)}
BOX_BATCHES = 4
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"compute capability {cap}, need (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[1 device] {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)


def phase_build():
    from dpt_tpu_torch.kernels import build

    from dpt_tpu_torch.kernels import intersect as K

    t0 = time.perf_counter()
    build.load_library()
    wall = time.perf_counter() - t0
    attrs = {(k, m): build.kernel_attributes(k, m == "occluded")
             for k in build.WALKS for m in build.KERNEL_MODES[k]}
    for stream, (n_rays, n_rows) in K3_STREAMS.items():
        g = K._geometry(n_rays, n_rows)
        attrs[(f"{build.INTERSECT} {stream} {k3_geometry_name(g)}",
               "nearest")] = build.intersect_attributes(g, n_rows)
    print(f"[2 build] {len(build.KERNEL_MODES)} kernels built in "
          f"{build.build_seconds:.2f} s (load {wall:.2f} s); registers/local "
          "bytes per thread/resident blocks per SM (K3: /dynamic shared "
          "bytes, at the geometry each phase-9 stream takes): "
          + ", ".join(f"{k}<{m}> {a['num_regs']}/{a['local_bytes']}/"
                      f"{a['blocks_per_sm']}"
                      + (f"/{a['smem_bytes']}" if "smem_bytes" in a else "")
                      for (k, m), a in attrs.items()), flush=True)
    return attrs


def incoherent_rays(scene, n, seed, device):
    """Rays leaving random points of the mesh (offset off the surface) in
    uniform random directions, coherence-sorted as the bounce queries are."""
    from dpt_tpu_torch.render.compaction import sort_permutation

    rng = np.random.default_rng(seed)
    v0, v1, v2 = (x.cpu().numpy() for x in scene.tri_vertices())
    tid = rng.integers(0, v0.shape[0], n)
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    a, b = 1.0 - s, s * (1.0 - r2)
    p = v0[tid] + a[:, None] * (v1[tid] - v0[tid]) + b[:, None] * (
        v2[tid] - v0[tid])
    nrm = np.cross(v1[tid] - v0[tid], v2[tid] - v0[tid])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    side = np.where(rng.random(n) < 0.5, 1.0, -1.0)[:, None]
    o = (p + side * 1e-3 * nrm).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    md = rng.uniform(-0.25, 2.0, n).astype(np.float32)
    o, d, md = (torch.as_tensor(x, device=device) for x in (o, d, md))
    bmin = scene.vertices.min(dim=0).values.to(device)
    bmax = scene.vertices.max(dim=0).values.to(device)
    perm = sort_permutation(o, d, md > 0, bmin, bmax)
    return o[perm].contiguous(), d[perm].contiguous(), md[perm].contiguous()


def primary_rays(camera, cfg, sample_batch, seed, device):
    from dpt_tpu_torch.render.raygen import generate_rays

    o, d, _ = generate_rays(camera, cfg, sample_batch)
    rng = np.random.default_rng(seed)
    md = torch.as_tensor(rng.uniform(0.5, 6.0, o.shape[0]).astype(np.float32),
                         device=device)
    return o, d, md


def median_ms(fn, inputs, warm=True):
    """Median over `inputs` of one call each, timed with CUDA events after
    one warm-up call (none with warm=False)."""
    if warm:
        fn(*inputs[0])
    torch.cuda.synchronize()
    times = []
    for args in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def design_of(name):
    """The design of a profiled walk kernel launch, from its template
    arguments: K1's group kernels are `quad_traverse_kernel<mode, 4>`."""
    return "group" if ", 4>" in name else "lane"


def kernel_device_ms(fns, inputs, kernel, windows=3, design=design_of):
    """Mean device time of one launch of `kernel` (csrc/<kernel>.cu's
    `<kernel>_kernel`) per design, from torch.profiler: `fns` maps each
    design to a call, and every call runs once on each input in one
    profiler window; the launches are told apart by `design` (a function
    of the kernel's name; default design_of).  The kernel
    alone, without its wrapper's host work.  The profiler may miss
    launches at the start of its window: a first kernel opens it, the mean
    is over the launches it saw, and a window that saw none of a design's
    is taken again, up to `windows` times.  If every window missed a design
    (the profiler has dropped all of a kernel's launches on the card), the
    calls are timed with CUDA events instead (probes.launch_ms: events
    around each call, all queued behind a sleep kernel, so each span is the
    kernel and its wrapper's output fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dpt_tpu_torch.probes import launch_ms

    for fn in fns.values():
        fn(*inputs[0])
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            for args in inputs:
                for fn in fns.values():
                    fn(*args)
            torch.cuda.synchronize()
        times = {d: [] for d in fns}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and f"{kernel}_kernel" in e.name):
                times.setdefault(design(e.name), []).append(
                    e.time_range.elapsed_us() / 1e3)
        seen = {d: len(ts) for d, ts in times.items()}
        if all(0 < n <= len(inputs) for n in seen.values()):
            return {d: statistics.fmean(ts) for d, ts in times.items()}
    print(f"[timing] profiler saw {seen} launches of {kernel} in {windows} "
          f"windows of {len(inputs)} calls; timed with CUDA events instead",
          flush=True)
    return {d: statistics.fmean(launch_ms(fn, inputs, n=len(inputs)))
            for d, fn in fns.items()}


def walk_module(kernel):
    """The wrapper module of one walk kernel: kernels/quad.py (K1) or
    kernels/wide.py (K2)."""
    if kernel == "quad_traverse":
        from dpt_tpu_torch.kernels import quad

        return quad
    from dpt_tpu_torch.kernels import wide

    return wide


def walk_functions(kernel):
    """(nearest, occluded, nearest_reference, occluded_reference) of one
    walk kernel."""
    m = walk_module(kernel)
    p = "quad" if kernel == "quad_traverse" else "wide"
    return tuple(getattr(m, f"{p}_{f}") for f in (
        "nearest", "occluded", "nearest_reference", "occluded_reference"))


def table_bytes(accel):
    nodes = accel.nodes_flat if hasattr(accel, "nodes_flat") else accel.nodes
    return 4 * (nodes.numel() + accel.tris.numel())


def bound(kernel, occluded, n_rays, stats, accel):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (rays in, results out, both tables read once) over the HBM rate, and
    the float operations these rays' walks need (records visited x slabs,
    triangle tests) over the float32 rate of unfused operations."""
    rays_in = (28 if occluded else 24) * n_rays
    out = (4 if occluded else 8) * n_rays
    nbytes = rays_in + out + table_bytes(accel)
    flops = (stats["node_visits"] * KERNELS[kernel][2] * FLOPS_PER_SLAB
             + stats["tri_tests"] * FLOPS_PER_TRI_TEST)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_UNFUSED_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lane_utilisation(ray_visits, warp=32):
    """Share of lanes a one-thread-per-ray warp keeps busy on a stream: the
    mean records visited per ray over the mean, across each `warp`
    consecutive rays, of their largest count (a warp walks until its
    longest walk ends; lanes past the last ray count as idle).  From the
    plain walk's per-ray counts."""
    v = ray_visits.double()
    groups = torch.cat([v, v.new_zeros((-v.numel()) % warp)]).view(-1, warp)
    return float(v.sum() / (warp * groups.max(dim=1).values.sum()))


def walk_designs(kernel):
    """{design: (nearest, occluded)} of one walk kernel, each called as the
    public wrappers are and launching that design: K1 one ray per lane
    and one per group of four lanes (forced through the wrapper's
    `_launch`, which skips the checks the public call makes of the same
    inputs), K2 one ray per lane (its public wrappers)."""
    if kernel != "quad_traverse":
        nearest, occluded, _, _ = walk_functions(kernel)
        return {"lane": (nearest, occluded)}
    m = walk_module(kernel)

    def design(v):
        def nearest(o, d, accel, cfg):
            t, tri = m._launch(o, d, None, accel, False, v)
            return t < m.T_MAX, t, tri

        def occluded(o, d, md, accel, cfg):
            return m._launch(o, d, md, accel, True, v)[1].bool()

        return nearest, occluded

    return {v: design(v) for v in ("lane", "group")}


def picked_design(kernel, n_rays):
    """The design the wrapper launches for a stream of `n_rays`."""
    if kernel != "quad_traverse":
        return "lane"
    return walk_module(kernel).walk_design(n_rays)


def compare_stream(kernel, name, inputs, accel, cfg, tag):
    """Every design of a walk kernel against its plain walk on one stream,
    exactly; returns per-mode stats: the wrapper's ms and the kernel's in
    the design the wrapper picks for this stream (what the render runs),
    and the kernel ms of each design."""
    nearest, occluded, nearest_ref, occluded_ref = walk_functions(kernel)
    designs = walk_designs(kernel)
    out = {}
    max_err = 0.0
    stats = {"nearest": {}, "occluded": {}}
    for i, (o, d, md) in enumerate(inputs):
        ph, pt, pi = nearest_ref(o, d, accel, cfg,
                                 stats=stats["nearest"] if i == 0 else None)
        po = occluded_ref(o, d, md, accel, cfg,
                          stats=stats["occluded"] if i == 0 else None)
        for v, (f_near, f_occ) in designs.items():
            kh, kt, ki = f_near(o, d, accel, cfg)
            ko = f_occ(o, d, md, accel, cfg)
            torch.cuda.synchronize()
            what = f"{kernel} ({v}) {name}"
            require(torch.equal(kh, ph), f"{what}: nearest hit differs")
            require(torch.equal(ki, pi), f"{what}: nearest tri differs")
            require(torch.equal(kt, pt), f"{what}: nearest t differs")
            require(torch.equal(ko, po), f"{what}: occluded differs")
            max_err = max(max_err, float((kt - pt).abs().max()))
    o, d, md = inputs[0]
    hit_frac = float(nearest(o, d, accel, cfg)[0].float().mean())
    occ_frac = float(occluded(o, d, md, accel, cfg).float().mean())

    def calls(mode, fs=(nearest, occluded)):
        if mode == "nearest":
            return (lambda o, d, md: fs[0](o, d, accel, cfg),
                    lambda o, d, md: nearest_ref(o, d, accel, cfg))
        return (lambda o, d, md: fs[1](o, d, md, accel, cfg),
                lambda o, d, md: occluded_ref(o, d, md, accel, cfg))

    for mode in ("nearest", "occluded"):
        run, run_ref = calls(mode)
        bms, by = bound(kernel, mode == "occluded", o.shape[0], stats[mode],
                        accel)
        stats[mode]["lane_utilisation"] = lane_utilisation(
            stats[mode].pop("ray_visits"))
        out[mode] = {
            "variant": picked_design(kernel, o.shape[0]),
            "ms": median_ms(run, inputs),
            **{f"kernel_ms_{v}": ms for v, ms in kernel_device_ms(
                {v: calls(mode, fs)[0] for v, fs in designs.items()},
                inputs, kernel).items()},
            "plain_ms": median_ms(run_ref, inputs),
            "max_abs_err": max_err if mode == "nearest" else 0.0,
            "bound_ms": bms,
            "bound_by": by,
            **stats[mode],
        }
        m = out[mode]
        m["kernel_ms"] = m["kernel_ms_" + m["variant"]]
    line = [f"[{tag}] {name}: R={o.shape[0]} hit {hit_frac:.4f} occluded "
            f"{occ_frac:.4f}; {'/'.join(designs)} exact on {len(inputs)} "
            "inputs"]
    for mode, m in out.items():
        line.append(
            f"{mode} {m['ms']:.3f} ms ({m['variant']}; kernel "
            f"{m['kernel_ms']:.4f}, "
            + ", ".join(f"{v} {m['kernel_ms_' + v]:.4f}" for v in designs)
            + f", plain {m['plain_ms']:.3f}, bound {m['bound_ms']:.4f} by "
            f"{m['bound_by']}; {m['node_visits']} visits, {m['tri_tests']} "
            f"tri tests; lane utilisation {m['lane_utilisation']:.4f})")
    print("; ".join(line), flush=True)
    return out


def phase_kernel(device, traversal, kernel, tag):
    """One walk kernel against its plain walk at the flagship tables."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    cfg = preset("sylveon512", width=1024, height=1024, traversal=traversal)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    require(scene.n_triangles == FLAGSHIP_TRIS,
            f"flagship mesh has {scene.n_triangles} triangles")
    t0 = time.perf_counter()
    accel = build_accel(scene, cfg)
    build_s = time.perf_counter() - t0
    print(f"[{tag}] tables: {scene.n_triangles} tris, SAH leaf 8 build+pack "
          f"{build_s:.2f} s, {type(accel).__name__} "
          f"{table_bytes(accel)} bytes, L={accel.tris.shape[0]} leaf rows, "
          f"depth {accel.max_depth}", flush=True)
    camera = OrbitCamera().camera(device)
    prim = [primary_rays(camera, cfg, b, 100 + b, device)
            for b in range(TIMED_CALLS)]
    inco = [incoherent_rays(scene, INCOHERENT_RAYS, 200 + k, device)
            for k in range(TIMED_CALLS)]
    counts = walk_module(kernel).launch_counts
    before = dict(counts)
    bounce = [incoherent_rays(scene, BOUNCE_RAYS, 500 + k, device)
              for k in range(TIMED_CALLS)]
    stats = {"primary": compare_stream(kernel, "primary 1024^2", prim, accel,
                                       cfg, tag),
             "incoherent": compare_stream(kernel, "incoherent 2^18", inco,
                                          accel, cfg, tag),
             "bounce": compare_stream(kernel, f"incoherent {BOUNCE_RAYS}",
                                      bounce, accel, cfg, tag)}
    require(counts != before, f"phase {tag} never launched {kernel}")
    return stats


def phase_render(tmp):
    from dpt_tpu_torch import cli
    from dpt_tpu_torch.kernels.quad import (
        design_counts,
        launch_counts,
        reset_launch_counts,
    )
    from dpt_tpu_torch.utils import native

    png = os.path.join(tmp, "flagship.png")
    metrics = os.path.join(tmp, "flagship.jsonl")
    batches = 4
    argv = ["render", "--preset", "sylveon512",
            "--procedural-tris", str(FLAGSHIP_TRIS_TARGET), "--width", "1024",
            "--height", "1024", "--batches", str(batches), "--out", png,
            "--metrics", metrics]
    sah_builds = native.calls["build_bvh_sah"]
    reset_launch_counts()
    img = cli.main(argv)
    torch.cuda.synchronize()
    counts, designs = dict(launch_counts), dict(design_counts)
    require(native.calls["build_bvh_sah"] == sah_builds + 1,
            "the render's SAH build did not take the native path")
    require(img.is_cuda and tuple(img.shape) == (1024, 1024, 3),
            f"image {tuple(img.shape)} on {img.device}")
    require(bool(torch.isfinite(img).all()), "image has non-finite values")
    require(bool((img >= 0).all()), "image has negative values")
    require(float(img.max()) > 0.0, "image is all zero")
    with open(png, "rb") as f:
        require(f.read(8) == b"\x89PNG\r\n\x1a\n", "PNG magic missing")
    want = {"nearest": 16 * batches, "occluded": 16 * batches}
    require(counts == want, f"K1 launches {counts}, want {want}")
    # The primary query walks all 1024² pixels; the 31 after it walk the
    # one live chunk of the static capacity (131,072 lanes, BOUNCE_RAYS of
    # them live), in groups of four lanes.
    want = {"lane": 0, "group": 31 * batches}
    want[picked_design("quad_traverse", 1024 * 1024)] += batches
    require(designs == want, f"K1 designs {designs}, want {want}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    require(len(rows) == batches, f"{len(rows)} metrics rows")
    print("[5 render] sylveon512 1024^2 x4 batches, 65,024 tris, 4 bounces "
          "(native SAH build): "
          f"K1 launches {counts}, by design {designs}; batch_ms "
          + ", ".join(f"{r['batch_ms']:.1f}" for r in rows)
          + "; gross rays/s "
          + ", ".join(f"{r['rays_per_s']:.4g}" for r in rows), flush=True)
    return counts, rows


def phase_devices(device):
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    cfg = preset("sylveon512", width=64, height=64)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device="cpu")
    accel = build_accel(scene, cfg)
    camera = OrbitCamera().camera("cpu")
    img_cpu = render_sample(scene, camera, cfg, 0, accel)
    img_gpu = render_sample(scene.to(device), camera.to(device), cfg, 0,
                            accel.to(device)).cpu()
    diff = (img_gpu - img_cpu).abs()
    bad = ~torch.isclose(img_gpu, img_cpu, rtol=1e-3, atol=2e-3)
    print(f"[6 devices] 64^2 cuda vs cpu: max |diff| {float(diff.max()):.3g}, "
          f"{int(bad.any(-1).sum())} of {64 * 64} pixels outside "
          "rtol 1e-3 / atol 2e-3", flush=True)
    require(not bool(bad.any()), "cuda and cpu images differ")


def _flagship_args(traversal):
    return ["--preset", "sylveon512", "--procedural-tris",
            str(FLAGSHIP_TRIS_TARGET), "--width", "1024", "--height", "1024",
            "--traversal", traversal]


def same_values(a, b):
    """Equal as np.testing.assert_array_equal has it: NaN matches NaN and
    0.0 matches -0.0 (a min over tied signed zeros may keep either)."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_refit(device):
    """refit_quad on the card with unchanged vertices reproduces pack_quad
    exactly (as the JAX package's test_refit_identity compares)."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels.quad import refit_quad
    from dpt_tpu_torch.scene.builder import procedural_scene

    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    accel = build_accel(scene, preset("sylveon512"))
    same = refit_quad(accel, scene.vertices, scene.indices)
    require(same_values(same.nodes_flat, accel.nodes_flat)
            and same_values(same.tris, accel.tris),
            "refit_quad with unchanged vertices differs from pack_quad")
    print(f"[7 optimize] refit_quad on the card with unchanged vertices "
          f"equals pack_quad ({accel.n_wide} records, "
          f"{accel.tris.shape[0]} leaf rows)", flush=True)


def walk_launches(tapes):
    """The walk launches of a taped render: per sub-sample, the primary
    query and then 15 nearest and 16 occluded queries in each chunk of the
    static capacity that ran (one pass at full width without
    compaction)."""
    k = [max(len(t.get("chunks", ())), 1) for t in tapes]
    return {"nearest": sum(1 + 15 * c for c in k),
            "occluded": sum(16 * c for c in k)}


def phase_optimize(tmp, traversal, opt_params):
    """`optimize` through the CLI at 1024², 3 tape-backward steps; returns
    (launch counts of the run, metrics rows)."""
    from dpt_tpu_torch import cli
    from dpt_tpu_torch.diff import grads

    kernel = "quad_traverse" if traversal == "quad" else "wide_traverse"
    mod = walk_module(kernel)
    target = os.path.join(tmp, f"target_{traversal}.npy")
    metrics = os.path.join(tmp, f"opt_{traversal}.jsonl")
    cli.main(["render", *_flagship_args(traversal), "--batches", "1",
              "--out", target, "--metrics", metrics])

    # Launches and ms of each taped forward and of each backward (the
    # playback render and its autograd pass), counted and timed around the
    # two functions the tape's autograd.Function calls.
    per_call = {"forward": [], "backward": []}
    ms = {"forward": [], "backward": []}
    # The walk launches each taped forward should make: a tape runs as many
    # chunks of the static capacity as its live lanes need (the vertex
    # optimisation grows the sphere past one chunk after its first step).
    want_forward = []

    def counted(fn, key):
        def wrapped(*a, **k):
            before = dict(mod.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
            per_call[key].append({m: mod.launch_counts[m] - before[m]
                                  for m in before})
            if key == "forward":
                want_forward.append(walk_launches(out[1]))
            return out
        return wrapped

    saved = grads.render_sample_taped, grads._grad_of
    grads.render_sample_taped = counted(saved[0], "forward")
    grads._grad_of = counted(saved[1], "backward")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod.reset_launch_counts()
    try:
        params, losses = cli.main([
            "optimize", *_flagship_args(traversal), "--target", target,
            "--opt-params", opt_params, "--init-albedo", "0.4", "0.4", "0.4",
            "--fixed-seeds", "--steps", "3", "--backward", "tape",
            "--metrics", metrics,
            "--out", os.path.join(tmp, f"rec_{traversal}.npz")])
        torch.cuda.synchronize()
    finally:
        grads.render_sample_taped, grads._grad_of = saved
    counts = dict(mod.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    with open(metrics) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [r for r in rows if r["event"] == "opt_step"]

    steps = 3
    require(len(losses) == steps and np.isfinite(losses).all(),
            f"{traversal} optimize losses {losses}")
    require([r["step"] for r in rows] == list(range(steps)),
            f"{traversal} optimize metrics rows {rows}")
    require(len(want_forward) == steps
            and per_call["forward"] == want_forward,
            f"{kernel} launches per taped forward {per_call['forward']}, "
            f"want {want_forward}")
    zero = {"nearest": 0, "occluded": 0}
    require(per_call["backward"] == [zero] * steps,
            f"{kernel} launches per backward {per_call['backward']}")
    require(counts == {m: sum(w[m] for w in want_forward) for m in counts},
            f"{kernel} launches in the run {counts}")
    albedo = float(params["albedo"].mean())
    if traversal == "quad":
        require(abs(albedo - 0.8) < abs(0.4 - 0.8),
                f"mean albedo {albedo} did not move toward 0.8")
    else:
        require(losses[-1] < losses[0], f"pallas losses {losses} not falling")
    print(f"[7 optimize] {traversal} 1024^2, {opt_params}: losses "
          + ", ".join(f"{x:.6g}" for x in losses)
          + f"; mean albedo {albedo:.4f}; {kernel} launches {counts} "
          f"(per taped forward {per_call['forward']}, 0 per backward); "
          "step_ms "
          + ", ".join(f"{r['step_ms']:.1f}" for r in rows)
          + " (taped forward " + ", ".join(f"{x:.1f}" for x in ms["forward"])
          + "; backward " + ", ".join(f"{x:.1f}" for x in ms["backward"])
          + f"); peak device memory {peak / 2**30:.3f} GiB", flush=True)
    return counts, rows, peak


def phase_grads(device):
    """Tape gradients at 64² on the card against the CPU, quad and
    pallas."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.diff.grads import PARAM_KEYS, tape_loss_and_grads
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device="cpu")
    camera = OrbitCamera().camera("cpu")
    rng = np.random.default_rng(5)
    target = torch.as_tensor(rng.uniform(0.0, 0.2, (64, 64, 3)).astype(
        np.float32))
    for traversal in ("quad", "pallas"):
        cfg = preset("sylveon512", width=64, height=64, traversal=traversal)
        accel = build_accel(scene, cfg)
        l_cpu, g_cpu = tape_loss_and_grads(scene, camera, cfg, target,
                                           sample_batch=0, accel=accel)
        l_gpu, g_gpu = tape_loss_and_grads(
            scene.to(device), camera.to(device), cfg, target.to(device),
            sample_batch=0, accel=accel.to(device))
        rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        require(rel <= 1e-5, f"{traversal}: loss {float(l_gpu)} on the card, "
                f"{float(l_cpu)} on the CPU")
        worst = 0.0
        for k in PARAM_KEYS:
            a, b = g_gpu[k].cpu(), g_cpu[k]
            scale = max(float(b.abs().max()), 1e-12)
            ok = torch.isclose(a, b, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * scale)
            require(bool(ok.all()), f"{traversal}: gradient {k} differs "
                    f"(max |diff| {float((a - b).abs().max()):.3g})")
            worst = max(worst, float((a - b).abs().max()) / scale)
        print(f"[8 grads] {traversal} 64^2 tape on the card vs the CPU: loss "
              f"rel diff {rel:.3g}; worst gradient |diff| / max|g| "
              f"{worst:.3g} (within rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x "
              "max|g|)", flush=True)


def k3_bound(n_rays, n_rows, n_tris):
    """(bound_ms, bound_by) of one K3 call: rays in (24 B) and out (8 B)
    and the table of `n_rows` rows read once, over the HBM rate, against a
    test of every ray against each of the `n_tris` triangles at
    FLOPS_PER_TRI_TEST each, over the unfused float32 rate.  The padded
    slots of the table's last row are not counted (pass `8 * n_rows` for
    the work the kernel does, padding included)."""
    nbytes = 32 * n_rays + 4 * 128 * n_rows
    flops = n_rays * n_tris * FLOPS_PER_TRI_TEST
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_UNFUSED_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k3_geometry_name(g):
    return f"R{g.rays_per_thread} S{g.cluster} T{g.threads}"


def compare_k3(name, inputs, tris, eps, tag):
    """K3 against its plain version on one stream: hit, tri and t exact on
    every input, through the wrapper (the geometry it picks) and in every
    geometry (forced through `_launch`); median ms of the wrapper and the
    plain version, the kernel's device ms in the picked geometry, its
    attributes, and the bound."""
    from dpt_tpu_torch.kernels import build
    from dpt_tpu_torch.kernels import intersect as K

    max_err = 0.0
    hit_frac = None
    for o, d in inputs:
        ph, pt, pi = K.intersect_nearest_reference(o, d, tris, eps)
        runs = [("wrapper", K.intersect_nearest(o, d, tris, eps))]
        for g in K.GEOMETRIES:
            t, i = K._launch(o, d, tris, eps, g)
            runs.append((k3_geometry_name(g), (t < K.T_MAX, t, i)))
        torch.cuda.synchronize()
        for what, (kh, kt, ki) in runs:
            require(torch.equal(kh, ph), f"K3 {name} ({what}): hit differs")
            require(torch.equal(ki, pi), f"K3 {name} ({what}): tri differs")
            require(torch.equal(kt, pt), f"K3 {name} ({what}): t differs")
            max_err = max(max_err, float((kt - pt).abs().max()))
        if hit_frac is None:
            hit_frac = float(ph.float().mean())
    require(0.0 < hit_frac, f"K3 {name}: no ray hit")
    n_rays, n_rows = inputs[0][0].shape[0], tris.shape[0]
    n_tris = int(tris.reshape(-1, 16)[:, 10].sum())
    g = K._geometry(n_rays, n_rows)

    def run(o, d):
        return K.intersect_nearest(o, d, tris, eps)

    out = {
        "ms": median_ms(run, inputs),
        "kernel_ms": kernel_device_ms({"k3": run}, inputs,
                                      "intersect_nearest",
                                      design=lambda _: "k3")["k3"],
        "plain_ms": median_ms(
            lambda o, d: K.intersect_nearest_reference(o, d, tris, eps),
            inputs),
        "max_abs_err": max_err,
        "n_rays": n_rays,
        "n_rows": n_rows,
        "n_tris": n_tris,
        "geometry": k3_geometry_name(g),
        **build.intersect_attributes(g, n_rows),
    }
    out["bound_ms"], out["bound_by"] = k3_bound(n_rays, n_rows, n_tris)
    out["bound_share"] = out["bound_ms"] / out["kernel_ms"]
    padded_ms, _ = k3_bound(n_rays, n_rows, 8 * n_rows)
    out["padded_share"] = padded_ms / out["kernel_ms"]
    print(f"[{tag}] {name}: R={n_rays}, {n_rows} table rows "
          f"({8 * n_rows} slots, {n_tris} triangles), hit {hit_frac:.4f}; "
          f"wrapper and {len(K.GEOMETRIES)} geometries exact on "
          f"{len(inputs)} inputs; {out['ms']:.4f} ms (kernel "
          f"{out['kernel_ms']:.4f} at {out['geometry']}, "
          f"{out['bound_share']:.1%} of the bound {out['bound_ms']:.4f} by "
          f"{out['bound_by']}, {out['padded_share']:.1%} counting the "
          f"padded slots too; plain {out['plain_ms']:.3f}); "
          f"{out['num_regs']} registers, "
          f"{out['local_bytes']} local bytes, {out['smem_bytes']} dynamic "
          f"shared bytes, {out['blocks_per_sm']} blocks per SM, "
          f"{out['max_clusters']} clusters at once", flush=True)
    return out


def phase_k3(device):
    """K3 against its plain version on box512's primary stream over the
    box, on its compacted chunk over the box and on incoherent rays over a
    table of real size."""
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels.intersect import pack_tris
    from dpt_tpu_torch.scene.builder import cornell_box_scene, procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "9 K3"
    t_phase = time.perf_counter()
    cfg = preset("box512", kernels="intersect")
    box = cornell_box_scene(device=device)
    camera = OrbitCamera().camera(device)
    prim = [primary_rays(camera, cfg, b, 300 + b, device)[:2]
            for b in range(TIMED_CALLS)]
    bounce = [incoherent_rays(box, K3_BOUNCE_RAYS, 600 + k, device)[:2]
              for k in range(TIMED_CALLS)]
    sphere = procedural_scene(K3_TRIS_TARGET, device=device)
    require(sphere.n_triangles == K3_TRIS,
            f"K3 sphere has {sphere.n_triangles} triangles")
    inco = [incoherent_rays(sphere, K3_INCOHERENT_RAYS, 400 + k, device)[:2]
            for k in range(TIMED_CALLS)]
    box_tris = pack_tris(*box.tri_vertices())
    out = {
        "primary": compare_k3("box512 primary 512^2, box (12 tris)", prim,
                              box_tris, cfg.eps, tag),
        "incoherent": compare_k3(
            f"incoherent 2^16, sphere ({K3_TRIS} tris)", inco,
            pack_tris(*sphere.tri_vertices()), cfg.eps, tag),
        "bounce": compare_k3(
            f"box512 compacted chunk {K3_BOUNCE_RAYS}, box (12 tris)",
            bounce, box_tris, cfg.eps, tag),
    }
    for stream, shape in K3_STREAMS.items():
        got = (out[stream]["n_rays"], out[stream]["n_rows"])
        require(got == shape, f"K3 {stream} stream: {got}, want {shape}")
    print(f"[{tag}] took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def nearest_queries_per_sample(cfg):
    """K3 calls of one sub-sample of trace_paths: the primary, one nearest
    query per bounce after the first (bounce 0 reuses the primary) and one
    per SSS step of every bounce.  The brute path is never
    coherence-sorted, and every query after the primary runs on the
    compacted live lanes, of which there is at least one."""
    return (1 + (cfg.max_depth - 1)
            + (cfg.max_depth * cfg.sss_bounces if cfg.enable_sss else 0))


def image_ok(img, shape, what):
    require(tuple(img.shape) == shape, f"{what}: shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), f"{what}: non-finite values")
    require(bool((img >= 0).all()), f"{what}: negative values")
    require(float(img.max()) > 0.0, f"{what}: all zero")


def phase_box(device, tmp):
    """The box-scale path: render_progressive at box512 with K3; returns
    (K3 launch counts of the 4-batch run, its metrics rows)."""
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels import intersect as K
    from dpt_tpu_torch.render.renderer import (
        render_progressive,
        render_sample,
    )
    from dpt_tpu_torch.scene.builder import cornell_box_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera
    from dpt_tpu_torch.utils.checkpoint import Checkpointer

    tag = "10 box"
    cfg = preset("box512", kernels="intersect")
    scene = cornell_box_scene(device=device)
    home = OrbitCamera()
    moved = home.view_update(40.0, -10.0)

    def source_of(poses):
        """A camera source giving poses[i] at its i-th call, then the last
        one."""
        calls = []

        def source():
            oc = poses[min(len(calls), len(poses) - 1)]
            calls.append(oc)
            return oc.state_tuple(), oc.camera(device)
        return source

    class KeepingCheckpointer(Checkpointer):
        """Also keeps every save as <path>.<batch>.npz."""

        def save(self, image, batch, extra=None, meta=None):
            super().save(image, batch, extra=extra, meta=meta)
            shutil.copyfile(self.path, f"{self.path}.{batch}.npz")

    ck = KeepingCheckpointer(os.path.join(tmp, "box.npz"))
    meta = {"camera_state": np.asarray(home.state_tuple(), np.float64),
            "config_key": "box512"}
    per_batch = cfg.spp * nearest_queries_per_sample(cfg)
    rows = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    img, n = render_progressive(
        scene, source_of([home]), cfg, n_batches=BOX_BATCHES,
        on_batch=lambda b, im, m: rows.append(m), checkpointer=ck,
        checkpoint_every=2, checkpoint_meta=meta)
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    require(n == BOX_BATCHES and len(rows) == BOX_BATCHES,
            f"{n} batches, {len(rows)} metrics rows")
    image_ok(img, (512, 512, 3), "box512 image")
    require(launches == {"nearest": per_batch * BOX_BATCHES},
            f"K3 launches {launches}, want {per_batch} per batch")
    print(f"[{tag}] box512 {cfg.width}x{cfg.height} x{BOX_BATCHES} batches, "
          f"{cfg.spp} spp, 12 tris, kernels=intersect: K3 launches "
          f"{launches} ({per_batch} per batch = {cfg.spp} spp x "
          f"{nearest_queries_per_sample(cfg)} nearest queries); batch_ms "
          + ", ".join(f"{r['batch_ms']:.1f}" for r in rows)
          + "; gross rays/s "
          + ", ".join(f"{r['rays_per_s']:.4g}" for r in rows), flush=True)

    saved, b2, aux = Checkpointer(f"{ck.path}.2.npz").load()
    require(b2 == 2 and str(aux["meta"]["config_key"]) == "box512",
            f"checkpoint at batch {b2}")
    resumed, n = render_progressive(scene, home.camera(device), cfg,
                                    n_batches=BOX_BATCHES, start_batch=b2,
                                    start_image=saved)
    require(n == BOX_BATCHES and torch.equal(resumed, img),
            "resume from the batch-2 checkpoint differs")
    seen = []
    reset, n = render_progressive(
        scene, source_of([moved, moved, home]), cfg, n_batches=BOX_BATCHES,
        on_batch=lambda b, im, m: seen.append(b))
    require(n == BOX_BATCHES and seen == [0, 1, 0, 1, 2, 3]
            and torch.equal(reset, img),
            f"camera change did not reset the accumulation ({seen})")
    print(f"[{tag}] resume from the batch-2 checkpoint and a camera change "
          "after 2 batches both give the 4-batch image bit for bit",
          flush=True)

    cam = home.camera(device)
    a = render_sample(scene, cam, cfg, 0)
    b = render_sample(scene, cam, cfg.replace(kernels="none"), 0)
    bad = ~torch.isclose(a, b, rtol=1e-4, atol=1e-5)
    print(f"[{tag}] kernels=intersect vs none, 512^2 16 spp on the card: "
          f"max |diff| {float((a - b).abs().max()):.3g}, "
          f"{int(bad.any(-1).sum())} pixels outside rtol 1e-4 / atol 1e-5",
          flush=True)
    require(not bool(bad.any()), "kernels=intersect and none differ")
    small = cfg.replace(width=32, height=32)
    c_gpu = render_sample(scene, cam, small, 0).cpu()
    c_cpu = render_sample(cornell_box_scene(device="cpu"),
                          home.camera("cpu"), small, 0)
    bad = ~torch.isclose(c_gpu, c_cpu, rtol=1e-3, atol=2e-3)
    print(f"[{tag}] 32^2 cuda vs cpu: max |diff| "
          f"{float((c_gpu - c_cpu).abs().max()):.3g}, "
          f"{int(bad.any(-1).sum())} of {32 * 32} pixels outside "
          "rtol 1e-3 / atol 2e-3", flush=True)
    require(not bool(bad.any()), "cuda and cpu box images differ")
    return launches, rows


def _run_cli(argv):
    """cli.main(argv) with its standard error captured: (result, text)."""
    from dpt_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = cli.main(argv)
    return out, err.getvalue()


def phase_cli(tmp):
    """render --checkpoint with resume and --compact-frac auto, a scripted
    interactive session, and info, on the card."""
    from dpt_tpu_torch import cli
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "11 cli"
    ck = os.path.join(tmp, "flagship_ck.npz")
    base = ["render", *_flagship_args("quad"), "--checkpoint", ck,
            "--metrics", os.path.join(tmp, "cli.jsonl")]
    _, err = _run_cli([*base, "--batches", "2", "--out",
                       os.path.join(tmp, "ck2.png")])
    require("resuming" not in err, f"first run resumed: {err!r}")
    img, err = _run_cli([*base, "--batches", "4", "--compact-frac", "auto",
                         "--out", os.path.join(tmp, "ck4.png")])
    require("resuming from batch 2" in err, f"no resume: {err!r}")
    require("auto compact_frac = " in err, f"no auto fraction: {err!r}")
    image_ok(img, (1024, 1024, 3), "resumed flagship image")
    auto = [x for x in err.splitlines() if x.startswith("auto")][0]
    print(f"[{tag}] render --checkpoint: 2 batches, then 4 with "
          f"--compact-frac auto: 'resuming from batch 2', '{auto}'",
          flush=True)

    parser = cli._build_parser()
    args = parser.parse_args(["interactive", "--preset", "box512",
                              "--out-dir", tmp])
    out = io.StringIO()
    img = cli.cmd_interactive(
        args, parser, stdout=out,
        stdin=io.StringIO("orbit 30 -10\nrender 2\nsave x.npy\nstatus\n"
                          "quit\n"))
    oc = OrbitCamera().view_update(30.0, -10.0)
    x = os.path.join(tmp, "x.npy")
    want = ["rendered to batch 2", f"saved {x} (2 batches)",
            f"batches=2 yaw={oc.yaw:.2f} pitch={oc.pitch:.2f} "
            f"radius={oc.radius:.3f} fov={oc.fov_deg:.1f}"]
    lines = out.getvalue().splitlines()
    require(lines == want, f"interactive printed {lines}")
    image_ok(torch.as_tensor(np.load(x)), (512, 512, 3), "interactive image")
    require(np.array_equal(np.load(x), img.cpu().numpy()),
            "saved image is not the session's")

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        info = cli.main(["info"])
    require(json.loads(text.getvalue()) == info and info["cuda_available"]
            and torch.cuda.get_device_name(0) in info["devices"],
            f"info printed {info}")
    print(f"[{tag}] interactive --preset box512 (512^2 kept): "
          f"{' | '.join(lines)}; info: torch {info['torch_version']}, "
          f"devices {info['devices']}", flush=True)


# The port's processes: every rank of a multi-process phase runs this
# program with the CLI's arguments, and prints its K1 launches at the end.
RANK_DRIVER = (
    "import json, sys\n"
    "from dpt_tpu_torch import cli\n"
    "from dpt_tpu_torch.kernels import quad\n"
    "quad.reset_launch_counts()\n"
    "cli.main(sys.argv[1:])\n"
    "print('K1_LAUNCHES ' + json.dumps(quad.launch_counts), flush=True)\n")
RANKS = 2
RANK_TIMEOUT = 240
ROOT = os.path.dirname(os.path.abspath(__file__))


def child_env():
    """This process's environment with the checkout first on PYTHONPATH,
    for the port's programs started as processes of their own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    return env


def run_cli_ranks(tag, argv_of_rank):
    """The CLI once per rank (RANKS ranks on the one card, gloo by the
    backend rule), all at once; returns [(output, K1 launches)] per rank.
    A rank that fails fails the phase, with every rank's output."""
    from dpt_tpu_torch.dist.launch import RankFailure, free_port, run_ranks

    port = free_port()
    env = child_env()
    cmds = [[sys.executable, "-c", RANK_DRIVER, *argv_of_rank(r),
             "--num-processes", str(RANKS), "--process-id", str(r),
             "--coordinator", f"localhost:{port}"] for r in range(RANKS)]
    try:
        outs = run_ranks(cmds, RANK_TIMEOUT, env=env, cwd=ROOT)
    except RankFailure as e:
        raise SmokeFailure(f"[{tag}] {e}") from None
    res = []
    for r, text in enumerate(outs):
        line = [x for x in text.splitlines() if x.startswith("K1_LAUNCHES ")]
        require(len(line) == 1, f"[{tag}] rank {r} printed no launch counts:"
                f"\n{text[-3000:]}")
        res.append((text, json.loads(line[0].split(" ", 1)[1])))
    return res


def metrics_rows(tag, path, outs, event):
    """Metrics rows of `event` per rank: rank 0's from the --metrics file,
    the others' from their standard output."""
    with open(path) as f:
        rows = [[json.loads(x) for x in f if x.strip()]]
    for text, _ in outs[1:]:
        rows.append([json.loads(x) for x in text.splitlines()
                     if x.startswith("{")])
    rows = [[x for x in rr if x.get("event") == event] for rr in rows]
    for r, rr in enumerate(rows):
        require(rr and all(x["rank"] == r and x["world_size"] == RANKS
                           for x in rr), f"[{tag}] rank {r} rows {rr}")
    return rows


def phase_sharded_render(tmp):
    """Two ranks render the flagship through `render --sharded`; rank 0's
    image equals the single process's."""
    from dpt_tpu_torch import cli
    from dpt_tpu_torch.kernels.quad import launch_counts, reset_launch_counts

    tag = "12 sharded render"
    batches = ["--batches", "2"]
    single = os.path.join(tmp, "single.npy")
    reset_launch_counts()
    cli.main(["render", *_flagship_args("quad"), *batches, "--out", single,
              "--metrics", os.path.join(tmp, "single.jsonl")])
    torch.cuda.synchronize()
    single_counts = dict(launch_counts)
    out = os.path.join(tmp, "sharded.npy")
    metrics = os.path.join(tmp, "sharded.jsonl")
    outs = run_cli_ranks(tag, lambda r: [
        "render", *_flagship_args("quad"), *batches, "--sharded", "--out",
        out, "--metrics", metrics])
    a, b = np.load(out), np.load(single)
    diff = float(np.abs(a - b).max())
    require(np.allclose(a, b, rtol=1e-5, atol=1e-6),
            f"[{tag}] rank 0's image differs from the single process's "
            f"(max |diff| {diff:.3g})")
    for r, (_, counts) in enumerate(outs):
        require(counts["nearest"] > 0 and counts["occluded"] > 0,
                f"[{tag}] rank {r} did not launch K1: {counts}")
    rows = metrics_rows(tag, metrics, outs, "batch")
    backends = {x["backend"] for rr in rows for x in rr}
    require(backends == {"gloo"}, f"[{tag}] backends {backends} (2 ranks "
            "on one card take gloo)")
    print(f"[{tag}] sylveon512 1024^2, 2 batches over {RANKS} ranks on one "
          f"card, backend gloo: rank 0's image vs the single process max "
          f"|diff| {diff:.3g}; K1 launches per rank "
          + ", ".join(str(c) for _, c in outs)
          + f" (single process {single_counts}); batch_ms per rank "
          + "; ".join(f"rank {r}: " + ", ".join(f"{x['batch_ms']:.1f}"
                                               for x in rr)
                      for r, rr in enumerate(rows)), flush=True)
    return [c for _, c in outs], rows


def phase_sharded_optimize(tmp):
    """Two ranks take 2 tape steps through `optimize --sharded` (rank 0
    alone keeps a checkpoint), equal to the single process; then resume
    from rank 0's checkpoint to step 3 on both ranks."""
    from dpt_tpu_torch import cli

    tag = "13 sharded optimize"
    target = os.path.join(tmp, "target_quad.npy")  # phase 7's
    require(os.path.exists(target), f"[{tag}] no target {target}")
    opt = ["optimize", *_flagship_args("quad"), "--target", target,
           "--opt-params", "albedo", "--init-albedo", "0.4", "0.4", "0.4",
           "--fixed-seeds", "--backward", "tape"]
    single = os.path.join(tmp, "single_opt.npz")
    cli.main([*opt, "--steps", "2", "--out", single, "--metrics",
              os.path.join(tmp, "single_opt.jsonl")])
    out = os.path.join(tmp, "sharded_opt.npz")
    metrics = os.path.join(tmp, "sharded_opt.jsonl")

    def argv(steps):
        return lambda r: [*opt, "--sharded", "--steps", str(steps), "--out",
                          out, "--metrics", metrics, "--checkpoint",
                          os.path.join(tmp, f"opt_ck{r}.npz")]

    outs = run_cli_ranks(tag, argv(2))
    a, b = np.load(out)["albedo"], np.load(single)["albedo"]
    require(np.allclose(a, b, rtol=1e-5, atol=1e-7),
            f"[{tag}] rank 0's albedo {a.tolist()} vs the single process's "
            f"{b.tolist()}")
    require(os.path.exists(os.path.join(tmp, "opt_ck0.npz"))
            and not os.path.exists(os.path.join(tmp, "opt_ck1.npz")),
            f"[{tag}] only rank 0 writes the checkpoint")
    for r, (_, counts) in enumerate(outs):
        require(counts["nearest"] > 0 and counts["occluded"] > 0,
                f"[{tag}] rank {r} did not launch K1: {counts}")
    rows = metrics_rows(tag, metrics, outs, "opt_step")
    resumed = run_cli_ranks(tag, argv(3))
    for r, (text, _) in enumerate(resumed):
        require("resuming from step 2" in text,
                f"[{tag}] rank {r} did not resume:\n{text[-3000:]}")
    rrows = metrics_rows(tag, metrics, resumed, "opt_step")
    require(all([x["step"] for x in rr] == [2] for rr in rrows[1:]),
            f"[{tag}] resumed rows {rrows}")
    print(f"[{tag}] 1024^2 quad albedo, 2 tape steps over {RANKS} ranks: "
          f"rank 0's albedo vs the single process max |diff| "
          f"{float(np.abs(a - b).max()):.3g}; K1 launches per rank "
          + ", ".join(str(c) for _, c in outs) + "; step_ms per rank "
          + "; ".join(f"rank {r}: " + ", ".join(f"{x['step_ms']:.1f}"
                                               for x in rr)
                      for r, rr in enumerate(rows))
          + "; resumed from rank 0's checkpoint at step 2 on every rank "
          "(rank 1 has no file)", flush=True)
    return [c for _, c in outs]


def phase_lbvh(device, tmp):
    """The flagship's LBVH built on the card ≡ built on the CPU after
    prune_bvh and pack_quad; K1 over it ≡ the plain walk; one flagship
    batch with --bvh-builder lbvh."""
    from dpt_tpu_torch.accel.bvh import build_bvh_sah, host_bvh, prune_bvh
    from dpt_tpu_torch.accel.lbvh import build_lbvh
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels import quad
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "14 lbvh"
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    cpu_scene = scene.to("cpu")
    times = []
    for _ in range(4):  # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = build_lbvh(scene.vertices, scene.indices, leaf_size=8)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cpu_tree = build_lbvh(cpu_scene.vertices, cpu_scene.indices, leaf_size=8)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    v = cpu_scene.vertices.numpy()
    idx = cpu_scene.indices.numpy()
    t0 = time.perf_counter()
    build_bvh_sah(v, idx, leaf_size=8)
    sah_ms = (time.perf_counter() - t0) * 1e3
    a, b = host_bvh(tree), host_bvh(cpu_tree)
    require(all(np.array_equal(getattr(a, f), getattr(b, f))
                and getattr(a, f).dtype == getattr(b, f).dtype
                for f in ("node_min", "node_max", "node_left", "node_right",
                          "tri_order")),
            f"[{tag}] the card's LBVH differs from the CPU's")
    corners = (v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]])
    qa = quad.pack_quad(prune_bvh(tree), *corners, device=device)
    qb = quad.pack_quad(prune_bvh(cpu_tree), *corners, device="cpu")
    require(qa.nodes_flat.cpu().numpy().tobytes()
            == qb.nodes_flat.numpy().tobytes()
            and qa.tris.cpu().numpy().tobytes() == qb.tris.numpy().tobytes(),
            f"[{tag}] pack_quad of the card's LBVH differs from the CPU's")
    cfg = preset("sylveon512", width=1024, height=1024, bvh_builder="lbvh")
    camera = OrbitCamera().camera(device)
    streams = {"primary 1024^2": primary_rays(camera, cfg, 0, 600, device),
               f"incoherent {BOUNCE_RAYS}": incoherent_rays(
                   scene, BOUNCE_RAYS, 700, device)}
    for name, (o, d, md) in streams.items():
        kh, kt, ki = quad.quad_nearest(o, d, qa, cfg)
        ko = quad.quad_occluded(o, d, md, qa, cfg)
        ph, pt, pi = quad.quad_nearest_reference(o, d, qa, cfg)
        po = quad.quad_occluded_reference(o, d, md, qa, cfg)
        torch.cuda.synchronize()
        require(torch.equal(kh, ph) and torch.equal(kt, pt)
                and torch.equal(ki, pi) and torch.equal(ko, po),
                f"[{tag}] K1 over the LBVH differs from the plain walk on "
                f"{name}")
    quad.reset_launch_counts()
    img, err = _run_cli(["render", *_flagship_args("quad"), "--bvh-builder",
                         "lbvh", "--batches", "1", "--out",
                         os.path.join(tmp, "lbvh.png"), "--metrics",
                         os.path.join(tmp, "lbvh.jsonl")])
    torch.cuda.synchronize()
    counts = dict(quad.launch_counts)
    image_ok(img, (1024, 1024, 3), f"[{tag}] LBVH flagship image")
    require(counts == {"nearest": 16, "occluded": 16},
            f"[{tag}] K1 launches {counts} in the LBVH batch")
    print(f"[{tag}] flagship {scene.n_triangles} tris, leaf 8: LBVH "
          f"{a.node_left.shape[0]} nodes, pruned and packed {qa.n_wide} "
          f"records / {qa.tris.shape[0]} leaf rows, card ≡ CPU byte for "
          f"byte; LBVH build on the card ms "
          + ", ".join(f"{x:.1f}" for x in times)
          + f" (first call first), on the CPU {cpu_ms:.1f}, host SAH build "
          f"{sah_ms:.1f}; K1 ≡ plain walk exactly on "
          + ", ".join(streams) + f"; one --bvh-builder lbvh batch: K1 "
          f"launches {counts}", flush=True)
    return counts, {"card_ms": times, "cpu_ms": cpu_ms, "sah_ms": sah_ms}


def _batch_ms(fn, n=3):
    """Host-clock ms of n synchronised calls, after one warm-up."""
    fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_wavefront(device):
    """One flagship batch with wavefront_sort is the batch without it, bit
    for bit, and launches K1; batch ms of each."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels import quad
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "15 wavefront"
    cfg = preset("sylveon512", width=1024, height=1024)
    wf = cfg.replace(wavefront_sort=True)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    accel = build_accel(scene, cfg)
    camera = OrbitCamera().camera(device)
    ref = render_sample(scene, camera, cfg, 5, accel)
    quad.reset_launch_counts()
    got = render_sample(scene, camera, wf, 5, accel)
    torch.cuda.synchronize()
    counts = dict(quad.launch_counts)
    require(torch.equal(got, ref), f"[{tag}] the wavefront-sorted batch "
            f"differs (max |diff| {float((got - ref).abs().max()):.3g})")
    require(counts == {"nearest": 16, "occluded": 16},
            f"[{tag}] K1 launches {counts}")
    ms = {}
    for name, c in (("per-query sort", cfg), ("wavefront sort", wf),
                    ("per-query sort again", cfg)):
        ms[name] = _batch_ms(lambda: render_sample(scene, camera, c, 6,
                                                   accel))
    print(f"[{tag}] flagship 1024^2 batch with wavefront_sort ≡ without, "
          f"bit for bit; K1 launches {counts}; batch ms (host clock, "
          "synchronised) " + "; ".join(
              f"{k}: " + ", ".join(f"{x:.1f}" for x in v)
              for k, v in ms.items()), flush=True)
    return counts, ms


def phase_walks(device):
    """bvh / packet / threaded render box512 at 64² on the card, allclose
    to brute."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import cornell_box_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "16 walks"
    cfg = preset("box512", width=64, height=64)
    scene = cornell_box_scene(device=device)
    camera = OrbitCamera().camera(device)
    ref = render_sample(scene, camera, cfg, 0)
    image_ok(ref, (64, 64, 3), f"[{tag}] brute image")
    line = []
    for trav in ("bvh", "packet", "threaded"):
        c = cfg.replace(traversal=trav)
        accel = build_accel(scene, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_sample(scene, camera, c, 0, accel)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        bad = ~torch.isclose(img, ref, rtol=1e-3, atol=2e-3)
        require(not bool(bad.any()), f"[{tag}] {trav} differs from brute "
                f"(max |diff| {float((img - ref).abs().max()):.3g})")
        line.append(f"{trav} max |diff| {float((img - ref).abs().max()):.3g}"
                    f" in {dt:.0f} ms")
    print(f"[{tag}] box512 64^2 {cfg.spp} spp on the card vs brute: "
          + "; ".join(line), flush=True)


def phase_native(tmp):
    """The native host runtime (g++, csrc/native_host.cpp): the flagship's
    SAH and median trees and the OBJ parse of its mesh, byte-identical to
    the numpy builders and the Python parser, each timed beside them."""
    from dpt_tpu_torch.accel.bvh import build_bvh_median, build_bvh_sah
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.obj import load_obj, write_obj
    from dpt_tpu_torch.utils import native

    tag = "17 native"
    require(native.available(), f"[{tag}] no g++: the native path is not "
            "taken on this machine")
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device="cpu")
    v, idx = scene.vertices.numpy(), scene.indices.numpy()
    require(idx.shape[0] == FLAGSHIP_TRIS, f"{idx.shape[0]} triangles")

    def timed(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            res = fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return res, out

    path = os.path.join(tmp, "flagship.obj")
    write_obj(path, v, idx)
    cases = {
        "sah": (lambda u: build_bvh_sah(v, idx, leaf_size=8, use_native=u),
                "build_bvh_sah", ("node_min", "node_max", "node_left",
                                  "node_right", "tri_order")),
        "median": (lambda u: build_bvh_median(v, idx, leaf_size=8,
                                              use_native=u),
                   "build_bvh", ("node_min", "node_max", "node_left",
                                 "node_right", "tri_order")),
        "obj": (lambda u: load_obj(path, use_native=u), "load_obj",
                ("vertices", "indices", "uvs", "mat_idx", "material_albedo")),
    }
    res = {}
    for name, (fn, counter, fields) in cases.items():
        before = native.calls[counter]
        got, nat_ms = timed(lambda: fn(True), 3)
        require(native.calls[counter] == before + 3,
                f"[{tag}] {name}: the native path was not taken")
        ref, np_ms = timed(lambda: fn(False), 1)
        require(all(getattr(got, f).tobytes() == getattr(ref, f).tobytes()
                    and getattr(got, f).shape == getattr(ref, f).shape
                    for f in fields),
                f"[{tag}] {name}: native differs from numpy")
        res[name] = {"native_ms": nat_ms, "numpy_ms": np_ms[0]}
    print(f"[{tag}] g++ build at first use {native.build_seconds:.2f} s; "
          f"flagship {FLAGSHIP_TRIS} tris, leaf 8, native ≡ "
          "numpy byte for byte: " + "; ".join(
              f"{k} native ms " + ", ".join(f"{x:.1f}" for x in r["native_ms"])
              + f", numpy ms {r['numpy_ms']:.1f}" for k, r in res.items()),
          flush=True)
    return res


def phase_capacity(device):
    """The static capacity: the flagship at compact_frac 0.125 (C = 131,072
    lanes, one live chunk of 8) and 0.0625 (C = 65,536, two live chunks),
    box512 at its 0.25 (C = 65,536 of 262,144) at its own framing (one live
    chunk) and from closer (every lane live: four), each image equal to
    the same render at compact_frac 0; K1's launches and designs per batch;
    batch ms (host clock, synchronised)."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels import intersect as K
    from dpt_tpu_torch.kernels import quad
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import cornell_box_scene, procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "18 capacity"
    cfg = preset("sylveon512", width=1024, height=1024)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    accel = build_accel(scene, cfg)
    camera = OrbitCamera().camera(device)
    ref = render_sample(scene, camera, cfg.replace(compact_frac=0.0), 5,
                        accel)
    launches, lines, ms = {}, [], {}
    for frac, want in ((0.125, 1), (0.0625, 2)):
        c = cfg.replace(compact_frac=frac)
        quad.reset_launch_counts()
        img = render_sample(scene, camera, c, 5, accel)
        torch.cuda.synchronize()
        counts, designs = dict(quad.launch_counts), dict(quad.design_counts)
        diff = float((img - ref).abs().max())
        require(torch.equal(img, ref), f"[{tag}] flagship at compact_frac "
                f"{frac} differs from 0 (max |diff| {diff:.3g})")
        n = {"nearest": 1 + 15 * want, "occluded": 16 * want}
        require(counts == n, f"[{tag}] K1 launches {counts} at {frac}, "
                f"want {n}")
        require(designs["group"] == 31 * want,
                f"[{tag}] K1 designs {designs} at {frac}")
        launches[frac] = counts
        lines.append(f"compact_frac {frac}: ≡ compact_frac 0 (max |diff| "
                     f"{diff:.3g}), K1 {counts} by design {designs}")
    for frac in (0.125, 0.0625, 0.0):
        c = cfg.replace(compact_frac=frac)
        ms[f"flagship {frac}"] = _batch_ms(
            lambda: render_sample(scene, camera, c, 6, accel))

    box = preset("box512", kernels="intersect")
    box_scene = cornell_box_scene(device=device)
    for name, orbit, b in (("box512", OrbitCamera(), box),
                           ("box512 radius 2.5, 4 spp",
                            OrbitCamera(radius=2.5), box.replace(spp=4))):
        cam = orbit.camera(device)
        K.reset_launch_counts()
        img = render_sample(box_scene, cam, b, 0)
        torch.cuda.synchronize()
        k3 = dict(K.launch_counts)
        off = render_sample(box_scene, cam, b.replace(compact_frac=0.0), 0)
        diff = float((img - off).abs().max())
        require(torch.equal(img, off), f"[{tag}] {name} at compact_frac "
                f"{b.compact_frac} differs from 0 (max |diff| {diff:.3g})")
        lines.append(f"{name} at {b.compact_frac}: ≡ compact_frac 0 (max "
                     f"|diff| {diff:.3g}), K3 {k3}")
        ms[name] = _batch_ms(lambda: render_sample(box_scene, cam, b, 1),
                             n=1)
        ms[f"{name} 0.0"] = _batch_ms(lambda: render_sample(
            box_scene, cam, b.replace(compact_frac=0.0), 1), n=1)
    print(f"[{tag}] " + "; ".join(lines) + "; batch ms (host clock, "
          "synchronised) " + "; ".join(
              f"{k}: " + ", ".join(f"{x:.1f}" for x in v)
              for k, v in ms.items()), flush=True)
    return launches, ms


def phase_syncs(device):
    """One flagship render_sample under torch.cuda.set_sync_debug_mode
    ("warn") at compact_frac 0.125 and at 0: the synchronising calls of
    each, counted by file:line; the compacted batch may not have more."""
    import warnings

    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "19 syncs"
    cfg = preset("sylveon512", width=1024, height=1024)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    accel = build_accel(scene, cfg)
    camera = OrbitCamera().camera(device)
    sites = {}
    for frac in (0.125, 0.0):
        c = cfg.replace(compact_frac=frac)
        render_sample(scene, camera, c, 7, accel)  # warm-up
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                render_sample(scene, camera, c, 8, accel)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        count = {}
        for w in caught:
            if str(w.message).startswith("called a synchronizing"):
                where = (f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                         if w.filename.startswith(ROOT) else
                         f"{w.filename}:{w.lineno}")
                count[where] = count.get(where, 0) + 1
        sites[frac] = count
    n = {f: sum(v.values()) for f, v in sites.items()}
    print(f"[{tag}] flagship render_sample under sync debug mode 'warn': "
          + "; ".join(f"compact_frac {f}: {n[f]} warnings "
                      + json.dumps(v, sort_keys=True)
                      for f, v in sites.items()), flush=True)
    require(n[0.125] <= n[0.0], f"[{tag}] the compacted batch syncs more "
            f"({n[0.125]}) than the uncompacted one ({n[0.0]})")
    return sites


def probe_bound(P, iters, stats, mt8_calls=0, tri_rows=0):
    """(bound_ms, bound_by) of one P5 / P6 / P2 launch: the rays in, the
    tiles and the sink out and the distinct records (64 B) and leaf rows
    (512 B) read, over the HBM rate, against each element's slab pair and
    add at every step of every chain, and FLOPS_PER_TRI_TEST for each slot
    of each mt8 call, over the unfused float32 rate.  A chain of dependent
    steps on one tile is a small share of the card by construction."""
    tile = 1024
    nbytes = (P * 6 * 4 * tile + P * 4 * tile + P * 12
              + 64 * stats["records"] + 512 * tri_rows)
    flops = (P * iters * tile * (2 * FLOPS_PER_SLAB + 1)
             + mt8_calls * tile * 8 * FLOPS_PER_TRI_TEST)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_UNFUSED_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(pairs):
    """Largest |a - b| over pairs of float tensors, 0 where a == b (equal
    infinities count 0)."""
    return max(float(torch.where(a == b, 0.0, (a.double() - b.double())
                                 .abs()).max()) for a, b in pairs)


def phase_probes(device, main_path_launches):
    """The walk probes: each kernel against its plain version on the card,
    bit for bit (P5, P6, P2: tiles and sink at PROBE_ITERS steps; P1 at
    every staged prefix on the flagship's BOUNCE_RAYS stream, also against
    K1's lane kernel), with the launches of one run through the probes'
    public functions, and one timing line each.  `main_path_launches` are
    the probes' launches in phases 3-19, which must be none."""
    from dpt_tpu_torch import probes
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels import build, quad
    from dpt_tpu_torch.probes import probe_interleave as p5
    from dpt_tpu_torch.probes import probe_interleave2 as p2
    from dpt_tpu_torch.probes import probe_interleave_any as p6
    from dpt_tpu_torch.probes import r3_smem_proto as p1
    from dpt_tpu_torch.scene.builder import procedural_scene

    tag = "20 probes"
    require(not any(main_path_launches.values()), f"[{tag}] phases 3-19 "
            f"launched probes: {main_path_launches}")
    t_phase = t0 = time.perf_counter()
    build.load_probe_library()
    print(f"[{tag}] probe library built in {build.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)", flush=True)

    # Inputs: the TPU probes' tables (seed 0) and ray tiles; the flagship's
    # tables and two 126,621-ray streams for P1.
    rng = np.random.default_rng(0)
    tables5 = [torch.as_tensor(t, device=device) for t in p5.node_tables(rng)]
    rays5 = {P: [torch.as_tensor(r, device=device)
                 for r in p5.ray_tiles(rng, P)] for P in p5.PS}
    sets2 = [tuple(torch.as_tensor(x, device=device) for x in st)
             for st in p2.tables(rng)]
    rays2 = {P: [torch.as_tensor(r, device=device)
                 for r in p5.ray_tiles(rng, P)] for P in p2.PS}
    cfg = preset("sylveon512", width=1024, height=1024, traversal="quad")
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    accel = build_accel(scene, cfg)
    modes1 = p1.modes(accel)
    bounce = [incoherent_rays(scene, BOUNCE_RAYS, 500 + k, device)[:2]
              for k in range(2)]
    chains = {("interleave", P): (p5.make(P, PROBE_ITERS), P)
              for P in p5.PS}
    chains.update({("interleave_any", P): (p6.make(P, PROBE_ITERS), P)
                   for P in p5.PS})
    steps = {(v, P): p2.make(P, v, PROBE_ITERS)
             for v in p2.VARIANTS for P in p2.PS}

    # The probes' path: every probe through its public function, the
    # launch counts set to 0 just before and read just after.
    probes.reset_launch_counts()
    out5 = {k: go(tables5[0], *rays5[P]) for k, (go, P) in chains.items()}
    out2 = {k: go(*sets2[0], *rays2[k[1]]) for k, go in steps.items()}
    out1 = [{(b, s): p1.smem_nearest(o, d, accel, s, b)
             for s, b in modes1} for o, d in bounce]
    torch.cuda.synchronize()
    want = {"interleave": len(p5.PS), "interleave_any": len(p5.PS),
            "interleave2": len(steps),
            "smem_walk": len(modes1) * len(bounce)}
    launches = {k: v for k, v in probes.launch_counts.items()
                if k in want or v}  # the walk probes', and any other's
    require(launches == want, f"[{tag}] probe launches {launches}, want "
            f"{want}")

    # Each against its plain version on the card, bit for bit; each
    # probe's max_abs_err over the float outputs it compared.
    stats = {}
    compared = {name: [] for name in launches}
    for (name, P), (tiles, sink) in out5.items():
        st = {}
        acc, ref_sink = p5.interleave_reference(
            tables5[0], p5.pack_rays(P, rays5[P]), PROBE_ITERS,
            name == "interleave_any", stats=st)
        got = torch.stack(tiles).reshape(P, -1)
        require(torch.equal(got, acc) and torch.equal(sink, ref_sink),
                f"[{tag}] {name} P={P} differs from its plain version")
        compared[name].append((got, acc))
        stats[name, P] = st
    for (v, P), (tiles, sink) in out2.items():
        st = {}
        acc, ref_sink = p2.interleave2_reference(
            *sets2[0], p5.pack_rays(P, rays2[P]), v, PROBE_ITERS, stats=st)
        got = torch.stack(tiles).reshape(P, -1)
        require(torch.equal(got, acc) and torch.equal(sink, ref_sink),
                f"[{tag}] interleave2 {v} P={P} differs from its plain "
                "version")
        compared["interleave2"].append((got, acc))
        stats[v, P] = st
    # P5, P6 and P2 once more, reading the SM each block ran on, against
    # the same plain versions (these launches come after the counts were
    # read); v is P2's variant.
    warps = {}
    for name, P, v in ([(name, P, None) for name, P in out5]
                       + [("interleave2", P, v) for v, P in out2]):
        if v is None:
            anyi = name == "interleave_any"
            sh, rays = p5.shape(P, anyi), p5.pack_rays(P, rays5[P])
            acc, ref_sink = p5.interleave_reference(tables5[0], rays,
                                                    PROBE_ITERS, anyi)
            sm = torch.full((p5.blocks(sh),), -1, dtype=torch.int32,
                            device=device)
            got, sink = p5.launch(tables5[0], rays, PROBE_ITERS, anyi, sh,
                                  sm)
        else:
            sh, rays = p2.SHAPE, p5.pack_rays(P, rays2[P])
            acc, ref_sink = p2.interleave2_reference(*sets2[0], rays, v,
                                                     PROBE_ITERS)
            sm = torch.full((p2.BLOCKS,), -1, dtype=torch.int32,
                            device=device)
            got, sink = p2.launch(*sets2[0], rays, v, PROBE_ITERS, sm)
        require(torch.equal(got, acc) and torch.equal(sink, ref_sink)
                and bool((sm >= 0).all()),
                f"[{tag}] {name} {v or ''} P={P} T={sh[0]} S={sh[1]} differs "
                "from its plain version or left a block's SM unread")
        compared[name].append((got, acc))
        warps[name, P] = p5.warps_per_sm(sm, sh[0])
    walk_stats = {}
    for k, (o, d) in enumerate(bounce):
        md = torch.zeros((o.shape[0],), dtype=torch.float32, device=device)
        pt, pi = quad._walk_reference(o, d, md, accel, False,
                                      quad.KERNEL_STACK,
                                      walk_stats if k == 0 else None)
        kt, ki = quad._launch(o, d, None, accel, False, "lane")
        torch.cuda.synchronize()
        for (b, s), (t, tri) in out1[k].items():
            require(torch.equal(t, pt) and torch.equal(tri, pi)
                    and torch.equal(t, kt) and torch.equal(tri, ki),
                    f"[{tag}] smem_walk block {b} n_staged={s} differs from "
                    "K1 lane or the plain walk")
            compared["smem_walk"] += [(t, pt), (t, kt)]
    errs = {name: max_abs_err(pairs) for name, pairs in compared.items()}
    attrs = {(b, s): p1.attributes(s, b) for s, b in modes1}
    print(f"[{tag}] exact: P5 and P6 at P {p5.PS} (through make, and "
          f"reading each block's SM; (T, S): P5 {p5.SHAPE[False]}, P6 "
          f"{p5.SHAPE[True]}), P2 A-D at P {p2.PS} (the same; (T, S) "
          f"{p2.SHAPE}), {PROBE_ITERS} steps, tiles and sink; "
          f"P1 in every mode (n_staged, block, cluster, replicated) "
          f"{[(s, *p1.shape(s, b)) for s, b in modes1]} (level starts "
          f"{p1.level_starts(accel)}) on {len(bounce)} x {BOUNCE_RAYS} "
          "rays = K1 lane = plain walk; registers/local bytes/blocks per "
          "SM/clusters at once "
          + ", ".join(f"{b}/{s}: {a['num_regs']}/{a['local_bytes']}/"
                      f"{a['blocks_per_sm']}/{a['max_clusters']}"
                      for (b, s), a in attrs.items())
          + f"; launches {launches}; max_abs_err {errs}", flush=True)
    # P1's reciprocal against 1.0f / x on every float32 of its input range.
    t0 = time.perf_counter()
    rcp = p1.rcp_check(device)
    require(rcp["differing"] == 0 and rcp["tested"] == rcp["expected"],
            f"[{tag}] P1's leaf-test reciprocal differs from 1.0f / x: "
            f"{rcp}")
    print(f"[{tag}] P1 reciprocal = 1.0f / x on every float32 with |x| >= "
          f"1e-6 (both signs, inf and NaN): {rcp['differing']} differing of "
          f"{rcp['tested']}, {rcp['fast']} on the fast path, in "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)

    # Timing: the wrapper (CUDA events, median), the kernel (events behind
    # a sleep, median), the plain version on the card (median), the bound.
    entries = {}

    def timed(name, label, call, kernel, plain, inputs, bound_ms_by,
              **extra):
        kms = statistics.median(probes.launch_ms(kernel, inputs, n=10))
        m = {"ms": median_ms(call, inputs), "kernel_ms": kms,
             "plain_ms": median_ms(plain, inputs[:2]),
             "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
             "max_abs_err": errs[name], "config": label}
        m.update(extra)
        print(f"[{tag}] {name} {label}: {m['ms']:.4f} ms (kernel "
              f"{kms:.4f}, plain {m['plain_ms']:.3f}, bound "
              f"{m['bound_ms']:.6f} by {m['bound_by']}, "
              f"{100 * m['bound_ms'] / kms:.3g}% of the kernel)"
              + "".join(f", {k} {v}" for k, v in extra.items()),
              flush=True)
        entries[name] = m

    packed5 = {P: p5.pack_rays(P, r) for P, r in rays5.items()}
    packed2 = {P: p5.pack_rays(P, r) for P, r in rays2.items()}
    for name in ("interleave", "interleave_any"):
        anyi = name == "interleave_any"
        P = max(p5.PS)
        sh = p5.SHAPE[anyi]
        per_p = {"shape": list(sh)}
        for q in p5.PS:
            ms = statistics.median(probes.launch_ms(
                lambda n, q=q: p5.launch(n, packed5[q], PROBE_ITERS, anyi),
                [(t,) for t in tables5], n=8))
            per_p[f"kernel_ms_P{q}"] = ms
            print(f"[{tag}] {name} P={q}: grid {p5.blocks(sh)}, block "
                  f"{sh[0]}, cluster {sh[1]} ({warps[name, q]} warps on "
                  f"the busiest SM): kernel {ms:.4f} ms, "
                  f"{ms * 1e6 / PROBE_ITERS / q:.1f} ns a step and chain",
                  flush=True)
        timed(name, f"P={P}, {PROBE_ITERS} steps",
              lambda n: chains[name, P][0](n, *rays5[P]),
              lambda n: p5.launch(n, packed5[P], PROBE_ITERS, anyi),
              lambda n: p5.interleave_reference(n, packed5[P], PROBE_ITERS,
                                                anyi),
              [(t,) for t in tables5],
              probe_bound(P, PROBE_ITERS, stats[name, P]), **per_p)
    P = max(p2.PS)
    st = stats["D", P]
    per_v = {f"kernel_ms_{v}_P{q}": statistics.median(probes.launch_ms(
                 lambda n, t, v=v, q=q: p2.launch(n, t, packed2[q], v,
                                                  PROBE_ITERS),
                 sets2, n=8))
             for v in p2.VARIANTS for q in p2.PS}
    per_v["shape"] = list(p2.SHAPE)
    for q in p2.PS:
        ns = {v: per_v[f"kernel_ms_{v}_P{q}"] * 1e6 / PROBE_ITERS
              for v in p2.VARIANTS}
        print(f"[{tag}] interleave2 P={q}: grid {p2.BLOCKS}, block "
              f"{p2.SHAPE[0]}, cluster {p2.SHAPE[1]} "
              f"({warps['interleave2', q]} warps on "
              "the busiest SM): ns a step and chain "
              + ", ".join(f"{v} {ns[v] / q:.1f}" for v in p2.VARIANTS)
              + f"; a step, B - A {ns['B'] - ns['A']:.1f}, C - B "
              f"{ns['C'] - ns['B']:.1f}, D - B {ns['D'] - ns['B']:.1f}",
              flush=True)
    per_v["latency_floor_ms"] = per_v["kernel_ms_A_P1"]
    print(f"[{tag}] interleave2 latency floor (A, P=1): {PROBE_ITERS} steps "
          f"x {per_v['kernel_ms_A_P1'] * 1e6 / PROBE_ITERS:.1f} ns = "
          f"{per_v['kernel_ms_A_P1']:.4f} ms", flush=True)
    timed("interleave2", f"D, P={P}, {PROBE_ITERS} steps",
          lambda n, t: steps["D", P](n, t, *rays2[P]),
          lambda n, t: p2.launch(n, t, packed2[P], "D", PROBE_ITERS),
          lambda n, t: p2.interleave2_reference(n, t, packed2[P], "D",
                                                PROBE_ITERS),
          sets2, probe_bound(P, PROBE_ITERS, st, st["mt8_calls"],
                             st["tri_rows"]), **per_v)
    per_s = {f"kernel_ms_block{b}_staged_{s}": statistics.median(
        probes.launch_ms(lambda o, d, s=s, b=b: p1.launch(o, d, accel, s, b),
                         bounce, n=6))
        for s, b in modes1}
    per_s["kernel_ms_k1_lane"] = statistics.median(probes.launch_ms(
        lambda o, d: quad._launch(o, d, None, accel, False, "lane"), bounce,
        n=6))
    per_s["blocks_per_sm"] = {f"{b}/{s}": a["blocks_per_sm"]
                              for (b, s), a in attrs.items()}
    per_s["clusters"] = {f"{b}/{s}": p1.shape(s, b)[1] for s, b in modes1}
    per_s["rcp_check"] = rcp
    best_b, best = min(((b, s) for s, b in modes1),
                       key=lambda k: per_s[f"kernel_ms_block{k[0]}_staged_"
                                           f"{k[1]}"])
    timed("smem_walk", f"{BOUNCE_RAYS} rays, block {best_b}, "
          f"n_staged={best}, cluster {p1.shape(best, best_b)[1]} (the "
          "fastest)",
          lambda o, d: p1.smem_nearest(o, d, accel, best, best_b),
          lambda o, d: p1.launch(o, d, accel, best, best_b),
          lambda o, d: p1.smem_nearest_reference(o, d, accel), bounce,
          bound("smem_walk", False, BOUNCE_RAYS, walk_stats, accel), **per_s)
    print(f"[{tag}] took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, entries


def library_calls(a4, device):
    """kernel -> one PyTorch call computing the same function on the same
    device-resident inputs as phase 21's timed launch, where there is one
    (timed beside the kernel, used nowhere in the port).  No single call
    sums a gather over k (P3, P4 a-c), runs the multiply-add chain (P4 e),
    a stack (P7-3) or makes the iota (P7-4), doubles a gathered row (P7-1:
    two calls) or rolls by a device-side shift (P8-2, P8-4)."""
    import torch.nn.functional as F

    from dpt_tpu_torch.probes import probe_pallas as p7
    from dpt_tpu_torch.probes import probe_pallas2 as p8

    rows = a4["rows"].long()
    blocks = a4["tab"].view(-1, 8 * 128)  # row block r is row r here
    offsets = torch.zeros(1, dtype=torch.long, device=device)
    t7, t8 = p7.table(device), p8.table(device)
    i7 = torch.tensor([3], dtype=torch.int32).to(device)
    i8 = torch.tensor([p8.IDX], dtype=torch.int32).to(device)
    return {
        "crossbar_rows": lambda: F.embedding_bag(rows, blocks, offsets,
                                                 mode="sum"),
        "scalar_extract": lambda: torch.index_select(t7[:, 0], 0, i7)
        .expand(1, 128),
        "dyn_lane_slice": lambda: torch.index_select(t8, 1, i8)
        .expand(8, 128),
        "scalar_dyn_lane": lambda: torch.index_select(t8[3], 0, i8)
        .expand(1, 128),
    }


def source_line(name):
    """`file:line` of a primitive probe's CUDA kernel function."""
    path = KERNELS[name][0]
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           path)) as f:
        for k, line in enumerate(f, 1):
            if f"{PRIMITIVE_FUNCTIONS[name]}(" in line:
                return f"{path}:{k}"
    raise SmokeFailure(f"{PRIMITIVE_FUNCTIONS[name]} not in {path}")


def crossbar_step_loops(tag):
    """P4-a's, P4-d's and P3-b's step loops in the probe library's machine
    code (`probes.sass.loop_counts`): A's must load one shared word a step
    (its lookup, not a value kept in a register), D's must hold no global
    load and a bulk copy a step (its rows come by the copy engine), P3-b's
    one shared load a lookup (a step) and no global load."""
    from dpt_tpu_torch.kernels import build
    from dpt_tpu_torch.probes import sass

    text = sass.dump(build.library_path("libdpt_probes",
                                        build._probe_sources()))
    loops = {}
    for key, fn, loads in (("crossbar_sublane", "sublane_kernel", ("LDS",)),
                           ("crossbar_rows", "rows_kernel", ("FADD",)),
                           ("gather_axis0", "column_kernel", ("LDS",))):
        found = sass.loop_counts(text, fn, loads=loads)
        require(len(found) == 1, f"[{tag}] {fn}: {len(found)} step loops "
                "in the machine code, want 1")
        c = found[0][1]
        loops[key] = {"instructions_per_step": c["per_step"],
                      "lds_per_step": c["lds_per_step"],
                      "ldg_per_step": c["ldg_per_step"],
                      "ublkcp_per_step": c["by_opcode"].get("UBLKCP", 0.0)}
    a, d = loops["crossbar_sublane"], loops["crossbar_rows"]
    g = loops["gather_axis0"]
    require(a["lds_per_step"] == 1.0, f"[{tag}] crossbar_sublane's step "
            f"loop: {a}, want one LDS a step")
    require(d["ldg_per_step"] == 0.0 and d["ublkcp_per_step"] >= 1.0,
            f"[{tag}] crossbar_rows' step loop: {d}, want no LDG and a "
            "bulk copy (UBLKCP) a step")
    require(g["lds_per_step"] == 1.0 and g["ldg_per_step"] == 0.0,
            f"[{tag}] gather_axis0's step loop: {g}, want one LDS a lookup "
            "and no LDG")
    print(f"[{tag}] machine code: crossbar_sublane's step loop "
          f"{a['instructions_per_step']:.2f} instructions and "
          f"{a['lds_per_step']:.2f} LDS a step; crossbar_rows' "
          f"{d['instructions_per_step']:.2f} instructions, "
          f"{d['ldg_per_step']:.2f} LDG and {d['ublkcp_per_step']:.2f} "
          "UBLKCP a step; gather_axis0's "
          f"{g['instructions_per_step']:.2f} instructions, "
          f"{g['lds_per_step']:.2f} LDS and {g['ldg_per_step']:.2f} LDG a "
          "step", flush=True)
    return loops


def phase_primitives(device):
    """The primitive probes P3, P4, P7, P8 at the TPU scripts' steps: every
    kernel launched once through its public wrapper (the launch counts set
    to 0 before and read after), each equal to its plain version bit for
    bit; the TPU probes' own checks of P7 and P8 (i in 0, 127, 128, 200,
    511); then each timed: the wrapper, the kernel (events behind a sleep),
    the plain version (the call after the checked one), the library call
    where there is one (device time, as the kernel's), the bounds of the
    card and of the one SM that runs the block."""
    from dpt_tpu_torch import probes
    from dpt_tpu_torch.kernels import build
    from dpt_tpu_torch.probes import probe_crossbar as p4
    from dpt_tpu_torch.probes import probe_gather as p3
    from dpt_tpu_torch.probes import probe_pallas as p7
    from dpt_tpu_torch.probes import probe_pallas2 as p8

    tag = "21 primitives"
    t_phase = time.perf_counter()
    build.load_probe_library()  # phase 20 built it
    rng = np.random.default_rng(0)
    g3 = [torch.as_tensor(x, device=device) for x in p3.inputs(rng)]
    a4 = {k: torch.as_tensor(v, device=device)
          for k, v in p4.inputs(rng).items()}
    full = {**p3.launches(*g3), **p4.launches(a4), **p7.launches(device),
            **p8.launches(device)}

    # The probes' path: every kernel once, through its public wrapper.
    probes.reset_launch_counts()
    outs = {name: ln.call() for name, ln in full.items()}
    torch.cuda.synchronize()
    launches = {k: v for k, v in probes.launch_counts.items()
                if k in PRIMITIVE_FUNCTIONS}
    want = {k: 0 for k in PRIMITIVE_FUNCTIONS}
    for name in full:
        want[probes.counter(name)] += 1
    require(launches == want and sum(probes.launch_counts.values())
            == sum(want.values()), f"[{tag}] launches {probes.launch_counts}"
            f", want {want}")
    errs, plain_ms = {}, {}
    for name, ln in full.items():
        got, plain = outs[name], ln.plain()
        require(got.is_cuda and got.dtype == plain.dtype
                and torch.equal(got, plain),
                f"[{tag}] {name} differs from its plain version")
        key = probes.counter(name)
        err = max_abs_err([(got.double(), plain.double())])
        errs[key] = max(errs.get(key, 0.0), err)
        # the checked call warmed it up: time the next one
        plain_ms[name] = median_ms(ln.plain, [()], warm=False)
    for i in (0, 127, 128, 200, 511):
        lines = p8.probe_lines(device, i)
        require(all(ok for _, ok in lines), f"[{tag}] P8 at {i}: {lines}")
    lines = p7.probe_lines(device)
    require(all(ok for _, ok, _ in lines), f"[{tag}] P7: {lines}")
    print(f"[{tag}] exact: {len(full)} launches at the TPU scripts' steps = "
          "their plain versions; the TPU probes' P7 and P8 checks hold; "
          f"launches {launches}; max_abs_err {errs}", flush=True)

    # The card's clocks a dependent operation, read by a bare chain apart
    # from E's code, for E's latency bound; E's first warp alone on one SM
    # beside it (both after the counts were read).
    cycles, ends = p4.op_cycles(a4["x"])
    require(torch.equal(ends.cpu(), p4.op_chain_reference(a4["x"].cpu())),
            f"[{tag}] the bare chain differs from its plain version")
    own, first = p4.chain_cycles(a4["x"])
    require(torch.equal(first, outs["crossbar_math"].reshape(-1)[:32]),
            f"[{tag}] crossbar_math's first warp alone differs from the "
            "tile's")
    print(f"[{tag}] the card: {cycles:.4f} clocks a dependent operation (a "
          f"bare chain of {p4.OP_CHAIN_STEPS} x {p4.OP_CHAIN_PAIRS} "
          "multiply-adds, one warp); crossbar_math one warp alone on one "
          f"SM, {p4.ITERS} steps x {p4.CHAIN_OPS} dependent operations: "
          f"{own:.4f} clocks an operation", flush=True)
    step_loops = crossbar_step_loops(tag)

    # Timing.
    library = library_calls(a4, device)
    for name, fn in library.items():  # the same function (sums reordered)
        got, ref = fn().reshape(-1), full[name].plain().reshape(-1)
        # atol 1e-3: D's 2,000 float32 terms summed in another order
        require(torch.allclose(got, ref, rtol=1e-5, atol=1e-3),
                f"[{tag}] the library call of {name} computes another "
                "function")
    timed = probes.time_launches(full, n=10, cycles_per_op=cycles)
    entries = {}
    for name, ln in full.items():
        m = timed[name]
        key = probes.counter(name)
        e = {"ms": median_ms(ln.call, [()] * TIMED_CALLS),
             "kernel_ms": m["kernel_ms"],
             "plain_ms": plain_ms[name],
             "bound_ms": m["bound_ms"],
             "bound_by": m["bound_by"],
             "max_abs_err": errs[key], "steps": ln.steps,
             "config": ln.label, "source_line": source_line(key),
             "library_ms": (statistics.median(probes.launch_ms(
                 library[key], [()], n=10)) if key in library else None)}
        if ln.steps > 1:
            e["ns_per_step"] = m["ns_per_step"]
            e["bound_sm_ms"] = m["sm_bound_ns_per_step"] * ln.steps * 1e-6
            e["bound_sm_ns_per_step"] = m["sm_bound_ns_per_step"]
        if "latency_bound_ms" in m:
            e["latency_bound_ms"] = m["latency_bound_ms"]
            e["cycles_per_op"] = m["cycles_per_op"]
            e["bound_share"] = m["share"]
        if key == "crossbar_math":
            e["own_cycles_per_op"] = own
        if key in step_loops:
            e["step_loop"] = step_loops[key]
        print(f"[{tag}] {name} ({ln.label}): {e['ms']:.4f} ms (kernel "
              f"{e['kernel_ms']:.4f}, plain {e['plain_ms']:.3f}, library "
              f"{e['library_ms']}, bound {e['bound_ms']:.6f} by "
              f"{e['bound_by']}"
              + (f"; {ln.steps} steps, {e['ns_per_step']:.1f} ns a step, "
                 f"its SM's bound {e['bound_sm_ns_per_step']:.1f}"
                 if ln.steps > 1 else "")
              + (f"; the chain's latency bound {e['latency_bound_ms']:.4f} "
                 f"ms at the card's {e['cycles_per_op']:.4f} clocks an "
                 "operation" + (f" (its own chain {own:.4f})"
                                if key == "crossbar_math" else "")
                 + f", {100 * e['bound_share']:.3g}% of the kernel against "
                 "the larger bound" if "latency_bound_ms" in e else "")
              + ")",
              flush=True)
        if key == "crossbar_lanes":  # one entry, K = 12's numbers
            first = entries.setdefault(key, {})
            first.update(e)
            first.update({f"kernel_ms_K{k.split('_K')[1]}":
                          timed[k]["kernel_ms"] for k in full
                          if k.startswith("crossbar_lanes_K")})
        else:
            entries[key] = e
    print(f"[{tag}] took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, entries


# The bench's JSON keys (bench.py:190-210) and the runs of phase 22: the
# flagship default (1024², 65,024 triangles, 4 iterations), the tape and the
# replay step, and the knot scene.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "step_ms",
              "rays_per_s_net", "live_in_by_depth", "live_in_res",
              "kernel_mode", "table_modes", "config")
BENCH_RUNS = (
    ("flagship", []),
    ("tape", ["--grad", "--iters", "2"]),
    ("replay", ["--grad", "--grad-replay", "--iters", "1"]),
    ("knot", ["--scene-family", "knot", "--iters", "2"]),
)
BENCH_TIMEOUT = 300


def check_bench_line(what, text):
    """The bench's one JSON line in `text`, checked: every key, a finite
    positive value, the CUDA build named, live_in_by_depth[0] == 1.0."""
    from dpt_tpu_torch.kernels import build

    lines = [x for x in text.splitlines() if x.strip()]
    require(len(lines) >= 1, f"[22 bench] {what} printed nothing")
    out = json.loads(lines[-1])
    missing = [k for k in BENCH_KEYS if k not in out]
    require(not missing, f"[22 bench] {what}: keys {missing} missing")
    require(isinstance(out["value"], (int, float))
            and np.isfinite(out["value"]) and out["value"] > 0,
            f"[22 bench] {what}: value {out['value']}")
    want = f"CUDA sm_90a {build.library_path().name}"
    require(out["kernel_mode"] == want,
            f"[22 bench] {what}: kernel_mode {out['kernel_mode']!r}, want "
            f"{want!r}")
    require(out["live_in_by_depth"][0] == 1.0,
            f"[22 bench] {what}: live_in_by_depth {out['live_in_by_depth']}")
    return lines[-1], out


def phase_bench():
    """`dpt_tpu_torch.bench.main` in this process for each of BENCH_RUNS
    (K1's launch counts set to 0 before each, read after), then
    `python -m dpt_tpu_torch.bench --quick` in a process of its own.
    Returns K1's launches over the in-process runs, by mode."""
    from dpt_tpu_torch import bench
    from dpt_tpu_torch.kernels import quad

    tag = "22 bench"
    total = {"nearest": 0, "occluded": 0}
    for name, argv in BENCH_RUNS:
        quad.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench.main(argv)
        wall = time.perf_counter() - t0
        counts, designs = dict(quad.launch_counts), dict(quad.design_counts)
        line, res = check_bench_line(name, out.getvalue())
        require(sum(counts.values()) > 0, f"[{tag}] {name}: K1 not launched")
        for k in total:
            total[k] += counts[k]
        print(line, flush=True)
        print(f"[{tag}] {name} ({' '.join(argv) or 'defaults'}): "
              f"{res['value']:.6g} gross rays/s, step {res['step_ms']} ms; "
              f"K1 launches {counts}, by design {designs}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"wall {wall:.1f} s", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dpt_tpu_torch.bench", "--quick"], cwd=ROOT,
        env=child_env(), capture_output=True, text=True,
        timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"[{tag}] python -m dpt_tpu_torch.bench "
            f"--quick exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line, res = check_bench_line("--quick", proc.stdout)
    print(line, flush=True)
    print(f"[{tag}] python -m dpt_tpu_torch.bench --quick: "
          f"{res['value']:.6g} gross rays/s at 256^2, step "
          f"{res['step_ms']} ms; wall {wall:.1f} s", flush=True)
    return total


def phase_oracle(device):
    """The card's renders against the port's scalar oracle: K1 (quad) on a
    300-triangle target of the sphere at 12², K3 (brute, intersect) on the
    box at 12²; then validate_bvh on the flagship's LBVH built on the card
    and its SAH tree.  Returns the launches of each kernel, by mode."""
    from dpt_tpu_torch.accel.bvh import (
        build_accel,
        build_bvh_sah,
        prune_bvh,
        validate_bvh,
    )
    from dpt_tpu_torch.accel.lbvh import build_lbvh
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels import intersect, quad
    from dpt_tpu_torch.oracle.scalar import render_oracle
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import cornell_box_scene, procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    tag = "23 oracle"
    moved = OrbitCamera().view_update(120.0, -60.0).zoom_update(0.9)
    cases = (
        ("K1", quad, procedural_scene(300, device=device),
         OrbitCamera().camera(device), preset("sylveon512", width=12,
                                              height=12)),
        ("K3", intersect, cornell_box_scene(device=device),
         moved.camera(device), preset("box512", width=12, height=12,
                                      kernels="intersect")),
    )
    launches = {}
    for name, module, scene, camera, cfg in cases:
        accel = build_accel(scene, cfg)
        module.reset_launch_counts()
        img = render_sample(scene, camera, cfg, 0, accel)
        torch.cuda.synchronize()
        launches[name] = dict(module.launch_counts)
        require(sum(launches[name].values()) > 0,
                f"[{tag}] {name} not launched")
        image_ok(img, (12, 12, 3), f"{name} render")
        t0 = time.perf_counter()
        ref = torch.as_tensor(render_oracle(scene, camera, cfg, 0),
                              dtype=torch.float32)
        oracle_s = time.perf_counter() - t0
        img = img.cpu()
        bad = ~torch.isclose(img, ref, rtol=1e-3, atol=2e-3)
        print(f"[{tag}] {name} ({cfg.traversal}, {scene.n_triangles} tris, "
              f"{cfg.max_depth} bounces, {cfg.spp} spp) 12^2 against the "
              f"oracle: max |diff| {float((img - ref).abs().max()):.3g}, "
              f"{int(bad.any(-1).sum())} of 144 pixels outside rtol 1e-3 / "
              f"atol 2e-3; launches {launches[name]}; oracle {oracle_s:.1f} s",
              flush=True)
        require(not bool(bad.any()), f"[{tag}] {name} render differs from "
                "the oracle")

    flagship = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    t0 = time.perf_counter()
    trees = {
        "lbvh leaf 1": build_lbvh(flagship.vertices, flagship.indices),
        "lbvh leaf 8 pruned": prune_bvh(build_lbvh(
            flagship.vertices, flagship.indices, leaf_size=8)),
        "sah leaf 8": build_bvh_sah(flagship.vertices.cpu().numpy(),
                                    flagship.indices.cpu().numpy()),
    }
    require(trees["lbvh leaf 1"].tri_order.is_cuda, "the LBVH is not on the "
            "card")
    for tree in trees.values():
        validate_bvh(tree, flagship.vertices, flagship.indices)
    print(f"[{tag}] validate_bvh passed on the flagship's "
          f"({flagship.n_triangles} tris) " + ", ".join(
              f"{k} ({v.node_left.shape[0]} nodes)" for k, v in trees.items())
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def probe_entries(launches, main_path_launches, entries):
    """The kernels-line entries of the probes: launches from the probes'
    path run (phase 20 or 21), launches_main_path from phases 3-19, the
    rest from the timed configuration."""
    out = []
    for name, m in entries.items():
        source, replaces, _ = KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "design": DESIGNS[name],
                    "launches": launches[name],
                    "launches_main_path": main_path_launches[name],
                    "library_ms": None, **m})
    return out


# Per-stream numbers each kernels-line entry carries: the primary stream's
# under these names, every other stream's with "_<stream>" appended.
ENTRY_KEYS = ("ms", "kernel_ms", "kernel_ms_lane", "kernel_ms_group",
              "variant", "plain_ms", "bound_ms", "bound_by",
              "lane_utilisation", "geometry", "bound_share", "num_regs",
              "smem_bytes", "blocks_per_sm")


def kernel_entries(kernel, stats, launches, **extra):
    """The kernels-line entries of one kernel, one per mode of
    stats[stream][mode] (streams "primary" and others)."""
    source, replaces, _ = KERNELS[kernel]
    out = []
    for mode in stats["primary"]:
        entry = {
            "name": f"{kernel}<{mode}>",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "design": DESIGNS[kernel],
            "launches": launches[mode],
            "max_abs_err": max(st[mode]["max_abs_err"]
                               for st in stats.values()),
            "library_ms": None,
        }
        for sname, st in stats.items():
            suffix = "" if sname == "primary" else f"_{sname}"
            entry.update({k + suffix: st[mode][k] for k in ENTRY_KEYS
                          if k in st[mode]})
        entry.update({k: v[mode] for k, v in extra.items()})
        out.append(entry)
    return out


def main():
    phase_device()
    device = torch.device("cuda", 0)
    from dpt_tpu_torch import probes

    probes.reset_launch_counts()
    phase_build()
    k1 = phase_kernel(device, "quad", "quad_traverse", "3 K1")
    k2 = phase_kernel(device, "pallas", "wide_traverse", "4 K2")
    with tempfile.TemporaryDirectory() as tmp:
        render_counts, _ = phase_render(tmp)
        phase_devices(device)
        check_refit(device)
        quad_counts, _, _ = phase_optimize(tmp, "quad", "albedo,vertices")
        wide_counts, _, _ = phase_optimize(tmp, "pallas",
                                           "albedo,light_intensity")
        phase_grads(device)
        k3 = phase_k3(device)
        box_counts, _ = phase_box(device, tmp)
        phase_cli(tmp)
        sharded_counts, _ = phase_sharded_render(tmp)
        sharded_opt_counts = phase_sharded_optimize(tmp)
        lbvh_counts, _ = phase_lbvh(device, tmp)
        wavefront_counts, _ = phase_wavefront(device)
        phase_walks(device)
        phase_native(tmp)
        capacity_counts, _ = phase_capacity(device)
        phase_syncs(device)
    main_path_probe_launches = dict(probes.launch_counts)
    probe_launches, probe_stats = phase_probes(device,
                                               main_path_probe_launches)
    primitive_launches, primitive_stats = phase_primitives(device)
    bench_counts = phase_bench()
    oracle_counts = phase_oracle(device)

    # No PyTorch call computes a BVH walk, the brute-force nearest hit or a
    # probe's chains, so library_ms is null; phase 21 times one where a
    # primitive probe has one (library_calls).
    per_rank = {f"launches_sharded_rank{r}": c
                for r, c in enumerate(sharded_counts)}
    per_rank.update({f"launches_sharded_optimize_rank{r}": c
                     for r, c in enumerate(sharded_opt_counts)})
    kernels = (kernel_entries("quad_traverse", k1, render_counts,
                              launches_optimize=quad_counts,
                              launches_bench=bench_counts,
                              launches_oracle=oracle_counts["K1"],
                              launches_lbvh=lbvh_counts,
                              launches_wavefront=wavefront_counts,
                              **{f"launches_compact_frac_{f}": c
                                 for f, c in capacity_counts.items()},
                              **per_rank)
               + kernel_entries("wide_traverse", k2, wide_counts)
               + kernel_entries("intersect_nearest",
                                {s: {"nearest": v} for s, v in k3.items()},
                                box_counts,
                                launches_oracle=oracle_counts["K3"])
               + probe_entries(probe_launches, main_path_probe_launches,
                               probe_stats)
               + probe_entries(primitive_launches, main_path_probe_launches,
                               primitive_stats))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

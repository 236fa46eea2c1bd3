"""P1: K1's nearest walk with the top levels of its record table staged in
shared memory.

Counterpart of `scripts/r3_smem_proto.py` (`smem_nearest`, pallas_call
:205, kernel `_kernel_smem`), which put every node record of the quad walk
in the TPU's scalar memory to learn whether the walk waits on reading its
records.  The card's shared memory (227 KB a block) cannot hold a large
table, but `pack_quad` numbers records breadth-first, so the top L levels
of the tree are a prefix of the table: `smem_nearest(..., n_staged)`
stages the first `n_staged` records in shared memory at each block's start
and reads the rest, and every leaf row, from global memory
(csrc/probes/smem_walk.cu), in blocks of 128 threads (K1's; `block`) or
1024 (which keep K1's occupancy at every prefix).  Its (t, tri) are K1's lane walk's and the
plain walk's bit for bit at every prefix: t is 1e30 (T_MAX) and tri 0 on a
miss.  The TPU probe votes one octant per tile where the port takes each
ray's own, so against it t is the same and tri the same away from equal-t
ties.

`level_starts` finds the level boundaries from the child pointers, once,
on the host; `staged_prefixes` gives the prefixes the probe sweeps: 0 and
the ends of levels 0-5 that fit.

    python -m dpt_tpu_torch.probes.r3_smem_proto [--inputs 5] [--rounds 2]

builds the flagship tables (65,024 triangles, SAH leaf 8) and, on the
three streams of scripts/torch_walk_ablation.py (primary 1024², 2^18
incoherent rays and 126,621 of them), checks every prefix in both block shapes
against K1's lane kernel and the plain walk, then times each beside K1's
lane and group designs in turns, the order reversed each round; prints the card's
name and power limit, each kernel's registers, local bytes and resident
blocks per SM, one line per measurement and one JSON line.  It uses the
repository's scripts/ (the ablation's streams), so it runs from a
checkout.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import torch

from dpt_tpu_torch import probes
from dpt_tpu_torch.kernels import quad

T_MAX = quad.T_MAX
RECORD_BYTES = 128
# The most dynamic shared memory one block may take on sm_90 (227 KB).
MAX_SHARED_BYTES = 232_448
MAX_STAGED = MAX_SHARED_BYTES // RECORD_BYTES
# The deepest level whose end the probe stages: levels 0-5 of a full
# 4-wide tree hold 1,365 records (175 KB).
MAX_LEVEL = 5
STREAMS = "primary:1024,incoherent:262144,incoherent:126621"
# The kernel's block shapes: K1's 128 threads, and 1024, one block of
# which keeps K1's 1024 threads an SM at every prefix.
BLOCKS = (128, 1024)
BLOCK = 128


def level_starts(accel: quad.QuadAccel) -> list:
    """The first record of each level of the quad tree, then the record
    count: a breadth-first walk over the child pointers of the non-empty
    slots.  Raises unless every level's children are exactly the records
    that follow it, in order (pack_quad's level order)."""
    rec = accel.nodes_flat.detach().reshape(-1, 32).cpu()
    ptr = rec[:, 24:28]
    child = ~torch.isnan(rec[:, 0:24:6]) & (ptr >= 0.0)
    starts = [0]
    lo, hi = 0, 1
    while True:
        starts.append(hi)
        kids = ptr[lo:hi][child[lo:hi]].to(torch.int64)
        if kids.numel() == 0:
            break
        if not torch.equal(kids, torch.arange(hi, hi + kids.numel())):
            raise ValueError(f"the records of level {len(starts) - 1} do "
                             "not follow level order")
        lo, hi = hi, hi + kids.numel()
    if hi != rec.shape[0]:
        raise ValueError(f"{rec.shape[0] - hi} records are not reached from "
                         "the root")
    return starts


def staged_prefixes(accel: quad.QuadAccel, max_level=MAX_LEVEL) -> list:
    """0, then the record count of levels 0..L for L = 0..max_level, each
    that fits in a block's shared memory (levels past the tree's last
    stop at the whole table)."""
    starts = level_starts(accel)
    ends = starts[1:max_level + 2]
    return [0] + sorted({e for e in ends if e <= MAX_STAGED})


def smem_nearest_reference(origin, direction, accel: quad.QuadAccel):
    """Plain PyTorch walk (K1's, kernels/quad.py): (t [R] f32, 1e30 on a
    miss; tri [R] int32, 0 on a miss)."""
    md = torch.zeros((origin.shape[0],), dtype=torch.float32,
                     device=origin.device)
    return quad._walk_reference(origin, direction, md, accel, False,
                                quad.KERNEL_STACK)


def launch(origin, direction, accel: quad.QuadAccel, n_staged: int,
           block=BLOCK):
    """One kernel launch on the current stream, in blocks of `block`
    threads: (t, tri).  Raises on a failed build or launch."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    R = origin.shape[0]
    dev = origin.device
    out_t = torch.empty((R,), dtype=torch.float32, device=dev)
    out_i = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return out_t, out_i
    rays = [x.contiguous() for x in (origin, direction)]
    tables = [x.contiguous() for x in (accel.nodes_flat, accel.tris)]
    if any(x.data_ptr() % 16 for x in tables):
        raise ValueError("accel tables must be 16-byte aligned")
    lib = load_probe_library()
    err = lib.dpt_quad_traverse_smem(
        *(x.data_ptr() for x in (*rays, *tables)), R, n_staged, block,
        out_t.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, "smem_walk", err)
    probes.launch_counts["smem_walk"] += 1
    return out_t, out_i


def smem_nearest(origin, direction, accel: quad.QuadAccel, n_staged=0,
                 block=BLOCK):
    """Nearest hit through the 4-wide walk with the first `n_staged`
    records in shared memory, in blocks of `block` threads (BLOCKS): (t
    [R] f32, T_MAX on a miss; tri [R] int32, 0 on a miss).  CUDA tensors
    launch the kernel; CPU tensors take the plain walk, which `n_staged` and
    `block` do not change."""
    quad._check_inputs(origin, direction, None, accel)
    need = 3 * accel.max_depth + 2
    if need > quad.KERNEL_STACK:
        raise ValueError(f"quad BVH depth {accel.max_depth} needs a stack of "
                         f"{need}, the kernel holds {quad.KERNEL_STACK}")
    if not 0 <= n_staged <= min(accel.n_wide, MAX_STAGED):
        raise ValueError(f"n_staged must be in [0, "
                         f"{min(accel.n_wide, MAX_STAGED)}], got {n_staged}")
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {BLOCKS}, got {block}")
    if origin.is_cuda:
        return launch(origin, direction, accel, n_staged, block)
    if origin.device.type != "cpu":
        raise ValueError(f"unsupported device {origin.device}")
    return smem_nearest_reference(origin, direction, accel)


def attributes(n_staged: int, block=BLOCK) -> dict:
    """Registers and local bytes per thread, and resident blocks of `block`
    threads per SM, with `n_staged` records staged."""
    import ctypes

    from dpt_tpu_torch.kernels.build import load_probe_library

    vals = [ctypes.c_int(0) for _ in range(3)]
    err = load_probe_library().dpt_quad_traverse_smem_attrs(
        n_staged, block, *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"smem_walk attributes: cudaError {err}")
    return dict(zip(("num_regs", "local_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", default=STREAMS)
    ap.add_argument("--inputs", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    root = pathlib.Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root / "scripts"))
    import torch_walk_ablation as ablation

    from dpt_tpu_torch.kernels import build

    card = probes.card_line()
    print(card, flush=True)
    accel, streams = ablation.stream_setup("quad_traverse",
                                           args.streams.split(","),
                                           args.inputs)
    prefixes = staged_prefixes(accel)
    starts = level_starts(accel)
    print(f"records {accel.n_wide}, level starts {starts}, staged prefixes "
          f"{prefixes}", flush=True)
    attrs = {(b, s): attributes(s, b) for b in BLOCKS for s in prefixes}
    for (b, s), a in attrs.items():
        print(f"smem_walk block {b} n_staged={s} ({s * RECORD_BYTES} B): "
              + json.dumps(a), flush=True)
    print("quad_traverse lane/group nearest: " + json.dumps({
        d: build.kernel_attributes(e, False)
        for d, e in quad._EXPORTS.items()}), flush=True)

    def k1(design):
        return lambda o, d: quad._launch(o, d, None, accel, False, design)

    runs = {f"k1_{d}": k1(d) for d in ("lane", "group")}
    runs.update({f"smem{b}_{s}": (lambda b, s: lambda o, d: launch(
        o, d, accel, s, b))(b, s) for b in BLOCKS for s in prefixes})
    for sname, (inputs, plain, info) in streams.items():
        print(f"{sname}: " + json.dumps(info["nearest"]), flush=True)
        for (o, d, _), (pt, pi, _) in zip(inputs, plain):
            kt, ki = k1("lane")(o, d)
            for b in BLOCKS:
                for s in prefixes:
                    st, si = launch(o, d, accel, s, b)
                    torch.cuda.synchronize()
                    if not (torch.equal(st, pt) and torch.equal(si, pi)
                            and torch.equal(st, kt) and torch.equal(si, ki)):
                        raise RuntimeError(
                            f"{sname}: smem_walk block {b} n_staged={s} "
                            "differs from K1 or the plain walk")
        print(f"{sname}: every prefix in both block shapes equals K1 lane "
              f"and the plain walk on {len(inputs)} inputs", flush=True)
    res = {s: {r: [] for r in runs} for s in streams}
    names = list(runs)
    for rnd in range(args.rounds):
        for sname, (inputs, _, _) in streams.items():
            for r in names if rnd % 2 == 0 else names[::-1]:
                ms = statistics.fmean(probes.launch_ms(
                    runs[r], [x[:2] for x in inputs], n=2 * len(inputs)))
                res[sname][r].append(ms)
                print(f"round {rnd} {sname} {r}: {ms:.4f} ms", flush=True)
    print(json.dumps({"probe": "r3_smem_proto",
                      "device": torch.cuda.get_device_name(0), "card": card,
                      "level_starts": starts, "prefixes": prefixes,
                      "attributes": {f"{b}/{s}": a
                                     for (b, s), a in attrs.items()},
                      "streams": {s: v[2]["nearest"]
                                  for s, v in streams.items()},
                      "kernel_ms": res}))


if __name__ == "__main__":
    main()

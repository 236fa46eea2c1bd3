"""P2: the walk-step variants A-D, P chains with a stack each.

Counterpart of `scripts/attic/probe_interleave2.py` (`make(P, variant)`,
pallas_call :160; `mt8` :33), which asked what in the wide walk's step
serialises it.  Each chain takes `iters` steps over its own [8, 128] ray
tile; a step loads record rid of the [8192, 16] view of `nodes`, takes the
slab pair of fields 0-5 and 6-11, and reduces each box's hit over the tile
(lhit, rhit):

  - A: rid = stack[0]; acc += (ltn <= ltf ? ltn : rtn); stack[0] = the
    pointer of the hit side (lhit: floor_mod(trunc(rec[12]) + rid, 8192),
    else the same of rec[13]).
  - B: a stack of 32 per chain: pop at max(sp - 1, 0), push both pointers
    when both boxes hit, the hit one when one does, sp kept in [1, 30].
  - C: B, and where rec[14] > 0 and lhit, `mt8` over leaf row rid % 512 of
    `tris` [512, 128] (a branch the whole tile takes or not).
  - D: B, and `mt8` at every step.

`mt8` is the probe's Möller–Trumbore (no valid field, the 1e-6 parallel
test only replaces det by 1, t > 1e-6) taking t where ok and t < acc.
Every accumulator starts at 0, so B, C and D return zeros for every input,
in the TPU probe and here.  The kernel's sink keeps its work observable:
`go` returns (P x [8, 128] f32, sink [P, 3] int32: the final sp, the final
top of the stack, the tile's count of mt8 slot tests with ok true).

CUDA tensors launch csrc/probes/interleave2.cu in its one shape `SHAPE`
(the tile over one cluster of S blocks of T threads, lhit / rhit exchanged
as one word a warp and step, each warp's copy of the stacks in shared
memory; P in {1, 8}); CPU tensors run `interleave2_reference`, the same
steps as torch ops (bit for bit on the card: -fmad=false).

    python -m dpt_tpu_torch.probes.probe_interleave2

times A-D at P = 1 and 8 on the card (`survey`, each checked equal to the
plain version bit for bit first), with P6 at the same P and shape: ns a
step and a step and chain, warps per SM (read from the SM each block ran
on), registers; then what each feature adds (B - A the stack, C - B the
leaf branch, D - B the unconditional leaf tests), A - P6, and the latency
floor (ITERS x A's ns a step at P = 1) beside the operations bound.
Prints the card's name and power limit and one JSON line.
scripts/torch_interleave2_shapes.py adds the one-block kernel of an older
tree to the same turns.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys

import numpy as np
import torch

from dpt_tpu_torch import probes
from dpt_tpu_torch.kernels.quad import _slab
from dpt_tpu_torch.probes import probe_interleave as p5
from dpt_tpu_torch.probes.probe_interleave import (
    N_RECORDS,
    N_ROWS,
    TILE,
    check_table,
    pack_rays,
    tile_rays,
    warps_per_sm,
)

ITERS = 512
N_TRI_ROWS = 512
STACK_WORDS = 32
VARIANTS = ("A", "B", "C", "D")
# The chain counts the kernel is built for (the TPU probe's main).
PS = (1, 8)
# The shape (threads per block T, blocks in the one cluster S) the kernel
# is built for, at every P: P6's (S = 16, T = 64 was within 6% of it at
# every variant and P on the H100, PERF.md).
SHAPE = (128, 8)
BLOCKS = TILE // SHAPE[0]  # T x BLOCKS covers the tile once
TIMED_LAUNCHES = 20
ROUNDS = 3  # `survey`'s rounds of TIMED_LAUNCHES each, in turns


def mt8(trow, ray, d, best):
    """The probe's Möller–Trumbore of the tile rays against the 8 slots of
    each chain's leaf row trow [P, 8, 16]: (best [P, 1024], ok count [P])."""
    ox, oy, oz = ray[:3]
    dx, dy, dz = d
    n_ok = torch.zeros(best.shape[0], dtype=torch.int64, device=best.device)
    for s in range(8):
        f = trow[:, s, :, None]  # [P, 16, 1]
        e1x, e1y, e1z = f[:, 3], f[:, 4], f[:, 5]
        e2x, e2y, e2z = f[:, 6], f[:, 7], f[:, 8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = torch.reciprocal(
            torch.where(det.abs() < 1e-6, torch.ones_like(det), det))
        tx, ty, tz = ox - f[:, 0], oy - f[:, 1], oz - f[:, 2]
        u = inv * (tx * px + ty * py + tz * pz)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = inv * (dx * qx + dy * qy + dz * qz)
        t = inv * (e2x * qx + e2y * qy + e2z * qz)
        ok = (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
        n_ok = n_ok + ok.sum(dim=1)
        best = torch.where(ok & (t < best), t, best)
    return best, n_ok


def interleave2_reference(nodes, tris, rays, variant, iters, stats=None):
    """Plain PyTorch P2: nodes [1024, 128], tris [512, 128], rays [P, 6,
    1024] -> (acc [P, 1024] f32, sink [P, 3] int32), in the kernel's order
    of operations, every chain's state on the device (no host sync).  With
    a `stats` dict, sets its "mt8_calls" to the mt8 calls made (chains x
    steps), and its "records" and "tri_rows" to the count of distinct
    records and leaf rows read."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    P = rays.shape[0]
    dev = rays.device
    table = nodes.reshape(N_RECORDS, 16)
    trows = tris.reshape(N_TRI_ROWS, 8, 16)
    ray, d = tile_rays(rays)
    acc = torch.zeros((P, rays.shape[2]), dtype=torch.float32, device=dev)
    chains = torch.arange(P, device=dev)
    stack = torch.zeros((P, STACK_WORDS), dtype=torch.int64, device=dev)
    stack[:, 0] = chains * 7 + 1
    sp = torch.ones(P, dtype=torch.int64, device=dev)
    n_ok = torch.zeros(P, dtype=torch.int64, device=dev)
    calls = torch.zeros((), dtype=torch.int64, device=dev)
    seen, rows = [], []
    for _ in range(iters):
        spm = (sp - 1).clamp(min=0)
        pos = torch.zeros_like(spm) if variant == "A" else spm
        rid = stack[chains, pos]
        seen.append(rid)
        rec = table[rid][:, :, None]  # [P, 16, 1]
        ltn, ltf = _slab(rec, 0, ray)
        rtn, rtf = _slab(rec, 6, ray)
        lhit = ((ltn <= ltf) & (ltf >= 0.0)).any(dim=1)
        lptr = torch.remainder(rec[:, 12, 0].to(torch.int32).long() + rid,
                               N_RECORDS)
        rptr = torch.remainder(rec[:, 13, 0].to(torch.int32).long() + rid,
                               N_RECORDS)
        if variant == "A":
            acc = acc + torch.where(ltn <= ltf, ltn, rtn)
            stack[chains, 0] = torch.where(lhit, lptr, rptr)
            continue
        rhit = ((rtn <= rtf) & (rtf >= 0.0)).any(dim=1)
        if variant in ("C", "D"):
            run = (rec[:, 14, 0] > 0.0) & lhit if variant == "C" else (
                torch.ones_like(lhit))
            best, ok = mt8(trows[rid % N_TRI_ROWS], ray, d, acc)
            acc = torch.where(run[:, None], best, acc)
            n_ok = n_ok + torch.where(run, ok, 0)
            calls = calls + run.sum()
            rows.append(torch.where(run, rid % N_TRI_ROWS, -1))
        both = lhit & rhit
        one = lhit ^ rhit
        first = torch.where(both, lptr, torch.where(lhit, lptr, rptr))
        stack[chains, spm] = torch.where(both | one, first,
                                         stack[chains, spm])
        stack[chains, spm + 1] = torch.where(both, rptr,
                                             stack[chains, spm + 1])
        sp = (spm + lhit.long() + rhit.long()).clamp(min=1, max=30)
    if stats is not None:
        stats["mt8_calls"] = int(calls)
        stats["records"] = int(torch.cat(seen).unique().numel())
        rows = torch.cat(rows).unique() if rows else torch.zeros(0)
        stats["tri_rows"] = int((rows >= 0).sum())
    top = stack[chains, torch.zeros_like(sp) if variant == "A"
                else (sp - 1).clamp(min=0)]
    sink = torch.stack([sp, top, n_ok], dim=1).to(torch.int32)
    return acc, sink


def check_args(P, variant):
    """Raise unless the kernel is built for P chains and `variant`."""
    if P not in PS:
        raise ValueError(f"the kernel is built for P in {PS}, got {P}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")


def launch(nodes, tris, rays, variant, iters, sm_of_block=None):
    """One kernel launch on the current stream in SHAPE: (acc [P, 1024],
    sink [P, 3] int32).  `sm_of_block` (int32 [BLOCKS], optional) gets the
    SM each block ran on.  Raises on a P or variant the kernel is not built
    for (before any build), a failed build or launch."""
    P = rays.shape[0]
    check_args(P, variant)
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    tables = [x.contiguous() for x in (nodes, tris)]
    if any(x.data_ptr() % 16 for x in tables):
        raise ValueError("nodes and tris must be 16-byte aligned")
    out = torch.empty((P, rays.shape[2]), dtype=torch.float32,
                      device=rays.device)
    sink = torch.empty((P, 3), dtype=torch.int32, device=rays.device)
    lib = load_probe_library()
    threads, cluster = SHAPE
    err = lib.dpt_probe_interleave2(
        tables[0].data_ptr(), tables[1].data_ptr(),
        rays.contiguous().data_ptr(), P, VARIANTS.index(variant), iters,
        threads, cluster, BLOCKS, out.data_ptr(), sink.data_ptr(),
        None if sm_of_block is None else sm_of_block.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    check_launch(lib, "interleave2", err)
    probes.launch_counts["interleave2"] += 1
    return out, sink


def attributes(P, variant):
    """Registers and local bytes per thread of the kernel of P chains."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    check_args(P, variant)
    lib = load_probe_library()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.dpt_probe_interleave2_attrs(
        P, VARIANTS.index(variant), SHAPE[0], SHAPE[1], BLOCKS,
        ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"interleave2 attributes at P={P} {variant}: "
                           f"cudaError {err}")
    return {"num_regs": regs.value, "local_bytes": local.value}


def make(P, variant, iters=ITERS):
    """go(nodes [1024, 128], tris [512, 128], *rays_flat) -> (P x [8, 128]
    f32, sink [P, 3] int32)."""

    def go(nodes, tris, *rays_flat):
        rays = pack_rays(P, rays_flat)
        check_table("nodes", nodes, (N_ROWS, 128), rays.device)
        check_table("tris", tris, (N_TRI_ROWS, 128), rays.device)
        if rays.is_cuda:
            acc, sink = launch(nodes, tris, rays, variant, iters)
        elif rays.device.type == "cpu":
            acc, sink = interleave2_reference(nodes, tris, rays, variant,
                                              iters)
        else:
            raise ValueError(f"unsupported device {rays.device}")
        return tuple(a.reshape(8, 128) for a in acc), sink

    return go


def tables(rng):
    """The TPU probe's 4 input sets: node tables with the row's first
    record's pointers (columns 12, 13) set to 1..96 and its leaf flag
    (column 14) to +-1, and normal leaf rows."""
    out = []
    for _ in range(4):
        nodes = rng.normal(size=(N_ROWS, 128)).astype(np.float32)
        nodes[:, 12] = rng.integers(1, 97, N_ROWS)
        nodes[:, 13] = rng.integers(1, 97, N_ROWS)
        nodes[:, 14] = rng.choice([-1.0, 1.0], N_ROWS)
        tris = rng.normal(size=(N_TRI_ROWS, 128)).astype(np.float32)
        out.append((nodes, tris))
    return out


def survey(others=()):
    """Time P2 A-D at every P of PS in SHAPE, P6 at the same P in its own
    shape, and each of `others` ((label, launch(nodes, tris, rays, variant,
    iters) -> (acc, sink), warps per SM)), ITERS steps, after checking each
    equal to its plain version bit for bit, over ROUNDS rounds of
    TIMED_LAUNCHES in turns (the order reversed every round); print a line
    each and the summary, and return the JSON dict."""
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    sets = [tuple(torch.as_tensor(x, device=dev) for x in s)
            for s in tables(rng)]
    packed = {P: pack_rays(P, [
        torch.as_tensor(rng.normal(size=(8, 128)).astype(np.float32),
                        device=dev) for _ in range(P * 6)]) for P in PS}
    # (kernel, label, variant, P, launch(nodes, tris), warps, attributes)
    configs = []
    main = f"T={SHAPE[0]} S={SHAPE[1]}"
    for P in PS:
        sm = torch.full((BLOCKS,), -1, dtype=torch.int32, device=dev)
        launch(*sets[0], packed[P], "A", 1, sm)
        torch.cuda.synchronize()
        if not bool((sm >= 0).all()):
            raise AssertionError(f"P2 {SHAPE} left a block's SM unread")
        warps = warps_per_sm(sm, SHAPE[0])
        for v in VARIANTS:
            configs.append((
                "P2", main, v, P,
                lambda n, t, P=P, v=v: launch(n, t, packed[P], v, ITERS),
                warps, attributes(P, v)))
        for label, call, warps in others:
            for v in VARIANTS:
                configs.append(("P2", label, v, P,
                                lambda n, t, P=P, v=v, call=call: call(
                                    n, t, packed[P], v, ITERS), warps, {}))
        sh6 = p5.SHAPE[True]
        configs.append(("P6", f"T={sh6[0]} S={sh6[1]}", "any", P,
                        lambda n, t, P=P: p5.launch(n, packed[P], ITERS,
                                                    True),
                        None, p5.attributes(P, True)))
    refs = {}
    for kernel, label, v, P, call, _, _ in configs:
        if (v, P) not in refs:
            refs[v, P] = (p5.interleave_reference(sets[0][0], packed[P],
                                                  ITERS, True)
                          if kernel == "P6" else interleave2_reference(
                              *sets[0], packed[P], v, ITERS))
        acc, sink = call(*sets[0])
        if not (torch.equal(acc, refs[v, P][0])
                and torch.equal(sink, refs[v, P][1])):
            raise AssertionError(f"{kernel} {label} {v} P={P} differs from "
                                 "its plain version")
    ms = {k: [] for k in range(len(configs))}
    for r in range(ROUNDS):
        order = range(len(configs)) if r % 2 == 0 else reversed(
            range(len(configs)))
        for k in order:
            ms[k] += probes.launch_ms(configs[k][4], sets, n=TIMED_LAUNCHES)
    rows = []
    for k, (kernel, label, v, P, _, warps, attrs) in enumerate(configs):
        m = statistics.median(ms[k])
        row = {"kernel": kernel, "shape": label, "variant": v, "P": P,
               "ms": m, "ns_per_step": m * 1e6 / ITERS,
               "ns_per_step_chain": m * 1e6 / ITERS / P,
               "warps_per_sm": warps, **attrs}
        rows.append(row)
        print(f"{kernel} {label:>10} {v:>3} P={P}: {m:8.4f} ms "
              f"{row['ns_per_step']:8.1f} ns/step "
              f"{row['ns_per_step_chain']:8.1f} ns/step/chain"
              + ("" if warps is None else f", {warps} warps/SM")
              + "".join(f", {a} {b}" for a, b in attrs.items()), flush=True)
    by = {(r["kernel"], r["shape"], r["variant"], r["P"]): r for r in rows}
    summary = {"iters": ITERS, "shape": list(SHAPE)}
    for label in dict.fromkeys(r["shape"] for r in rows
                               if r["kernel"] == "P2"):
        ns = {(v, P): by["P2", label, v, P]["ns_per_step"]
              for v in VARIANTS for P in PS}
        # what each feature adds to a step: the stack, the leaf branch, the
        # leaf tests at every step
        summary[label] = {f"{name}_ns_per_step": {
            P: ns[hi, P] - ns[lo, P] for P in PS}
            for name, hi, lo in (("stack_B_minus_A", "B", "A"),
                                 ("branch_C_minus_B", "C", "B"),
                                 ("leaf_D_minus_B", "D", "B"))}
    six = f"T={p5.SHAPE[True][0]} S={p5.SHAPE[True][1]}"
    summary["A_minus_P6_ns_per_step"] = {
        P: by["P2", main, "A", P]["ns_per_step"]
        - by["P6", six, "any", P]["ns_per_step"] for P in PS}
    floor = by["P2", main, "A", 1]
    summary["latency_floor_ms"] = floor["ms"]
    summary["latency_floor_ns_per_step"] = floor["ns_per_step"]
    summary["ops_bound_ms_P1"] = p5.ops_bound_ms(1, ITERS)
    print(f"latency floor (A, P=1, {main}): {ITERS} steps x "
          f"{floor['ns_per_step']:.1f} ns = {floor['ms']:.4f} ms, against "
          f"the card's operations bound {summary['ops_bound_ms_P1']:.6f} ms",
          flush=True)
    for k, v in summary.items():
        if k not in ("iters", "latency_floor_ms", "latency_floor_ns_per_step",
                     "ops_bound_ms_P1"):
            print(f"{k}: {json.dumps(v)}", flush=True)
    result = {"probe": "probe_interleave2", "device":
              torch.cuda.get_device_name(0), "card": card, "rows": rows,
              "summary": summary}
    print(json.dumps(result))
    return result


def main():
    survey()


if __name__ == "__main__":
    main()

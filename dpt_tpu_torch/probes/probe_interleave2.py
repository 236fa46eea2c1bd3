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

CUDA tensors launch csrc/probes/interleave2.cu (one block of 1024 threads,
P in {1, 8}, the stacks in shared memory); CPU tensors run
`interleave2_reference`, the same steps as torch ops (bit for bit on the
card: -fmad=false).

    python -m dpt_tpu_torch.probes.probe_interleave2

times A-D at P = 1 and 8 on the card and prints the TPU probe's lines,
the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from dpt_tpu_torch import probes
from dpt_tpu_torch.kernels.quad import _slab
from dpt_tpu_torch.probes.probe_interleave import (
    N_RECORDS,
    N_ROWS,
    check_table,
    pack_rays,
    tile_rays,
)

ITERS = 512
N_TRI_ROWS = 512
STACK_WORDS = 32
VARIANTS = ("A", "B", "C", "D")
# The chain counts the kernel is built for (the TPU probe's main).
PS = (1, 8)
TIMED_LAUNCHES = 20


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


def launch(nodes, tris, rays, variant, iters):
    """One kernel launch on the current stream: (acc [P, 1024], sink [P,
    3] int32).  Raises on a failed build or launch."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    P = rays.shape[0]
    if P not in PS:
        raise ValueError(f"the kernel is built for P in {PS}, got {P}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    tables = [x.contiguous() for x in (nodes, tris)]
    if any(x.data_ptr() % 16 for x in tables):
        raise ValueError("nodes and tris must be 16-byte aligned")
    out = torch.empty((P, rays.shape[2]), dtype=torch.float32,
                      device=rays.device)
    sink = torch.empty((P, 3), dtype=torch.int32, device=rays.device)
    lib = load_probe_library()
    err = lib.dpt_probe_interleave2(
        tables[0].data_ptr(), tables[1].data_ptr(),
        rays.contiguous().data_ptr(), P, VARIANTS.index(variant), iters,
        out.data_ptr(), sink.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    check_launch(lib, "interleave2", err)
    probes.launch_counts["interleave2"] += 1
    return out, sink


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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    sets = [tuple(torch.as_tensor(x, device=dev) for x in s)
            for s in tables(rng)]
    rows = []
    for variant in VARIANTS:
        for P in PS:
            packed = pack_rays(P, [
                torch.as_tensor(rng.normal(size=(8, 128)).astype(np.float32),
                                device=dev) for _ in range(P * 6)])
            ms = statistics.median(probes.launch_ms(
                lambda n, t: launch(n, t, packed, variant, ITERS),
                sets, n=TIMED_LAUNCHES))
            per = ms * 1e-3 / ITERS
            print(f"{variant} P={P}:  {ms:8.3f} ms  {per * 1e9:8.1f} "
                  f"ns/iter  {per / P * 1e9:8.1f} ns/iter/chain", flush=True)
            rows.append({"variant": variant, "P": P, "ms": ms,
                         "ns_per_iter": per * 1e9,
                         "ns_per_iter_chain": per / P * 1e9})
    print(json.dumps({"probe": "probe_interleave2",
                      "device": torch.cuda.get_device_name(0),
                      "card": card, "iters": ITERS, "rows": rows}))


if __name__ == "__main__":
    main()

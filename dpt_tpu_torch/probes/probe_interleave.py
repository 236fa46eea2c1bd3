"""P5: P independent pointer-chase chains over one ray tile.

Counterpart of `scripts/probe_interleave.py` (`make(P)`, pallas_call :94):
does running more walks at once hide the latency of each step's dependent
load?  Each chain p starts at record 7p + 1 of the [8192, 16] view of
`nodes` [1024, 128] and takes `iters` steps over its own [8, 128] ray
tile: the slab pair of the record's fields 0-5 and 6-11, acc += (ltn <= ltf
and ltf >= 0 ? ltn : rtn), next record floor_mod(trunc(rec[12]) + rid,
8192).  The TPU probe reads row rid // 8 and rolls record rid % 8 to lanes
0-15; here that is one load of record rid.

`make(P, iters)` returns `go(nodes, *rays_flat)` with the TPU probe's
arguments (P x 6 ray tiles ox oy oz dx dy dz), giving (a tuple of P [8, 128]
accumulators, sink [P, 3] int32: 0, the chain's final record, 0).  CUDA
tensors launch csrc/probes/interleave.cu in its kernel's shape `SHAPE`
(P5: 32 blocks of one warp; P6: one cluster of 8 blocks of 128 threads;
P in {1, 2, 4, 8}); CPU tensors run `interleave_reference`, the same steps as torch ops
(bit for bit on the card: -fmad=false).  P6 (`probe_interleave_any`) is
the same with the tile's any(hit) added into the next index.

    python -m dpt_tpu_torch.probes.probe_interleave

times both kernels on the card (`survey`): at P = 1, 2, 4, 8, ns per step
and per step and chain, warps per SM (read from the SM each block ran on),
registers; then the chain's latency floor beside the
card's operations bound, the chains per SM at which ns per step and chain
stops falling, and P6's cost a step over P5.  Prints the
card's name and power limit and one JSON line.
scripts/torch_interleave_shapes.py adds the one-block kernel of an older
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

ITERS = 512
N_ROWS = 1024  # node table rows
N_RECORDS = N_ROWS * 8  # 16-float records
TILE = 8 * 128  # elements of a ray tile
# The chain counts the kernel is built for (the TPU probe's main).
PS = (1, 2, 4, 8)
# The shape (threads per block T, blocks per cluster S) each kernel is
# built for, by whether the any is in the index, timed on the H100: P5
# spreads the tile over 1024 / T blocks without a cluster (T = 64-256 were
# slower at every P), P6 over one cluster of S blocks of 1024 / S threads
# (S = 2 was slower; S = 4 and 16 were at most 3% faster, at one P each).
SHAPE = {False: (32, 1), True: (128, 8)}
TIMED_LAUNCHES = 20
# Float operations of one step of one chain for one tile element: two slab
# tests of 25 (6 sub, 6 mul, 10 min / max, 3 compares) and the add.
OPS_PER_STEP = 51
# The H100 SXM's float32 rate without FMA (its 67e12 FLOP/s count an FMA as
# two operations; the kernel is built with -fmad=false).
F32_OPS_PER_S = 33.5e12


def shape(P, any_in_index):
    """The (T, S) the wrapper launches for P chains: its kernel's SHAPE."""
    if P not in PS:
        raise ValueError(f"the kernel is built for P in {PS}, got {P}")
    return SHAPE[bool(any_in_index)]


def blocks(shape_):
    """Blocks of a shape: T x blocks covers the tile once."""
    return TILE // shape_[0]


def check_shape(P, any_in_index, shape_):
    """Raise unless the kernel is built for P chains in `shape_`."""
    if P not in PS:
        raise ValueError(f"the kernel is built for P in {PS}, got {P}")
    if tuple(shape_) != SHAPE[bool(any_in_index)]:
        raise ValueError(
            f"{'P6' if any_in_index else 'P5'} is built for the shape (T, "
            f"S) {SHAPE[bool(any_in_index)]}, got {tuple(shape_)}")


def ops_bound_ms(P, iters):
    """The card's operations bound of one launch: OPS_PER_STEP for every
    tile element, step and chain at F32_OPS_PER_S."""
    return TILE * iters * P * OPS_PER_STEP / F32_OPS_PER_S * 1e3


def probe_inv(d):
    """1 / where(|d| < 1e-20, 1e-20, d): the probes' inverse (no sign
    handling, unlike K1's)."""
    return torch.reciprocal(
        torch.where(d.abs() < 1e-20, torch.full_like(d, 1e-20), d))


def pack_rays(P, rays_flat):
    """The P x 6 ray tiles [8, 128] as one contiguous [P, 6, 1024] tensor."""
    if len(rays_flat) != 6 * P:
        raise ValueError(f"need {6 * P} ray tiles for P = {P}, got "
                         f"{len(rays_flat)}")
    for r in rays_flat:
        if r.dtype != torch.float32 or tuple(r.shape) != (8, 128):
            raise ValueError("each ray tile must be float32 [8, 128]")
    return torch.stack(rays_flat).reshape(P, 6, 8 * 128)


def check_table(name, x, shape_, device):
    if x.dtype != torch.float32 or tuple(x.shape) != shape_:
        raise ValueError(f"{name} must be float32 {list(shape_)}, got "
                         f"{x.dtype} {list(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the rays on {device}")


def tile_rays(rays):
    """(ox, oy, oz, ix, iy, iz) [P, 1024] and (dx, dy, dz) of packed rays."""
    o = [rays[:, k] for k in range(3)]
    d = [rays[:, 3 + k] for k in range(3)]
    return (*o, *(probe_inv(x) for x in d)), d


def interleave_reference(nodes, rays, iters, any_in_index=False,
                         stats=None):
    """Plain PyTorch P5 (P6 with `any_in_index`): nodes [1024, 128], rays
    [P, 6, 1024] -> (acc [P, 1024] f32, sink [P, 3] int32), in the
    kernel's order of operations, with the chain indices kept on the
    device (no host sync).  With a `stats` dict, sets its "records" to the
    count of distinct records the chains read."""
    P = rays.shape[0]
    dev = rays.device
    table = nodes.reshape(N_RECORDS, 16)
    ray, _ = tile_rays(rays)
    acc = torch.zeros((P, rays.shape[2]), dtype=torch.float32, device=dev)
    rid = torch.arange(P, device=dev) * 7 + 1
    seen = []
    for _ in range(iters):
        seen.append(rid)
        rec = table[rid][:, :, None]  # [P, 16, 1]
        ltn, ltf = _slab(rec, 0, ray)
        rtn, rtf = _slab(rec, 6, ray)
        hit = (ltn <= ltf) & (ltf >= 0.0)
        acc = acc + torch.where(hit, ltn, rtn)
        nxt = rec[:, 12, 0].to(torch.int32).long() + rid
        if any_in_index:
            nxt = nxt + hit.any(dim=1).long()
        rid = torch.remainder(nxt, N_RECORDS)
    if stats is not None:
        stats["records"] = int(torch.cat(seen).unique().numel())
    zero = torch.zeros_like(rid)
    return acc, torch.stack([zero, rid, zero], dim=1).to(torch.int32)


def launch(nodes, rays, iters, any_in_index=False, shape_=None,
           sm_of_block=None):
    """One kernel launch on the current stream in `shape_` (T, S) (default:
    `shape`'s): (acc [P, 1024], sink [P, 3] int32).  `sm_of_block` (int32
    [blocks], optional) gets the SM each block ran on.  Raises on a refused
    shape, a failed build or launch."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    P = rays.shape[0]
    shape_ = shape(P, any_in_index) if shape_ is None else tuple(shape_)
    check_shape(P, any_in_index, shape_)
    nodes = nodes.contiguous()
    if nodes.data_ptr() % 16:
        raise ValueError("nodes must be 16-byte aligned")
    out = torch.empty((P, rays.shape[2]), dtype=torch.float32,
                      device=rays.device)
    sink = torch.empty((P, 3), dtype=torch.int32, device=rays.device)
    lib = load_probe_library()
    threads, cluster = shape_
    err = lib.dpt_probe_interleave(
        nodes.data_ptr(), rays.contiguous().data_ptr(), P, iters,
        int(any_in_index), threads, cluster, blocks(shape_), out.data_ptr(),
        sink.data_ptr(), None if sm_of_block is None else
        sm_of_block.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    name = "interleave_any" if any_in_index else "interleave"
    check_launch(lib, name, err)
    probes.launch_counts[name] += 1
    return out, sink


def attributes(P, any_in_index):
    """Registers and local bytes per thread of the kernel of P chains."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    shape_ = shape(P, any_in_index)
    lib = load_probe_library()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.dpt_probe_interleave_attrs(
        P, int(any_in_index), shape_[0], shape_[1], blocks(shape_),
        ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"interleave attributes at P={P} {shape_}: "
                           f"cudaError {err}")
    return {"num_regs": regs.value, "local_bytes": local.value}


def make_go(P, iters, any_in_index):
    def go(nodes, *rays_flat):
        rays = pack_rays(P, rays_flat)
        check_table("nodes", nodes, (N_ROWS, 128), rays.device)
        if rays.is_cuda:
            acc, sink = launch(nodes, rays, iters, any_in_index)
        elif rays.device.type == "cpu":
            acc, sink = interleave_reference(nodes, rays, iters,
                                             any_in_index)
        else:
            raise ValueError(f"unsupported device {rays.device}")
        return tuple(a.reshape(8, 128) for a in acc), sink

    return go


def make(P, iters=ITERS):
    """go(nodes [1024, 128], *rays_flat) -> (P x [8, 128] f32, sink)."""
    return make_go(P, iters, False)


def node_tables(rng):
    """The TPU probe's 4 node tables: normal floats, with column 12 of each
    row (the pointer of the row's first record) set to 1..96."""
    tables = []
    for _ in range(4):
        nodes = rng.normal(size=(N_ROWS, 128)).astype(np.float32)
        nodes[:, 12] = rng.integers(1, 97, N_ROWS)
        tables.append(nodes)
    return tables


def ray_tiles(rng, P):
    """The TPU probe's P x 6 normal ray tiles [8, 128]."""
    return [rng.normal(size=(8, 128)).astype(np.float32)
            for _ in range(P * 6)]


def warps_per_sm(sm_of_block, threads):
    """The most warps any SM held in a launch, from the SM of each
    block."""
    counts = torch.bincount(sm_of_block.long().cpu())
    return int(counts.max()) * threads // 32


def _stop_point(rows, tol=0.1):
    """The first P of PS after which ns per step and chain falls by less
    than `tol` (the chains at which the latency is hidden), else the last."""
    for a, b in zip(PS, PS[1:]):
        if rows[b] > (1 - tol) * rows[a]:
            return a
    return PS[-1]


def survey(others=(), iters=ITERS, rounds=2):
    """Time P5 and P6 on the card at every P of PS in their SHAPE (and each
    of `others`: (label, any_in_index, launch(nodes, rays, iters) -> (acc,
    sink), warps per SM)), after checking each equal to
    `interleave_reference` bit for bit; print a line each and the summary,
    and return the JSON dict."""
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    tables = [torch.as_tensor(t, device=dev) for t in node_tables(rng)]
    packed = {P: pack_rays(P, [torch.as_tensor(r, device=dev)
                               for r in ray_tiles(rng, P)]) for P in PS}
    configs = []  # (kernel, label, P, launch, warps per SM, attributes)
    for anyi in (False, True):
        kernel = "P6" if anyi else "P5"
        sh = SHAPE[anyi]
        for P in PS:
            sm = torch.empty(blocks(sh), dtype=torch.int32, device=dev)
            launch(tables[0], packed[P], 1, anyi, sh, sm)
            configs.append((kernel, f"T={sh[0]} S={sh[1]}", P,
                            lambda n, P=P, anyi=anyi: launch(
                                n, packed[P], iters, anyi),
                            warps_per_sm(sm, sh[0]), attributes(P, anyi)))
            for label, oany, call, warps in others:
                if oany == anyi:
                    configs.append((kernel, label, P,
                                    lambda n, P=P, call=call: call(
                                        n, packed[P], iters), warps, {}))
    refs = {(anyi, P): interleave_reference(tables[0], packed[P], iters,
                                            anyi)
            for anyi in (False, True) for P in PS}
    for kernel, label, P, call, _, _ in configs:
        acc, sink = call(tables[0])
        ref = refs[kernel == "P6", P]
        if not (torch.equal(acc, ref[0]) and torch.equal(sink, ref[1])):
            raise AssertionError(f"{kernel} {label} P={P} differs from "
                                 "interleave_reference")
    ms = {k: [] for k in range(len(configs))}
    for r in range(rounds):
        order = range(len(configs)) if r % 2 == 0 else reversed(
            range(len(configs)))
        for k in order:
            ms[k] += probes.launch_ms(configs[k][3], [(t,) for t in tables],
                                      n=TIMED_LAUNCHES)
    rows = []
    for k, (kernel, label, P, _, warps, attrs) in enumerate(configs):
        m = statistics.median(ms[k])
        row = {"kernel": kernel, "shape": label, "P": P, "ms": m,
               "ns_per_step": m * 1e6 / iters,
               "ns_per_step_chain": m * 1e6 / iters / P,
               "warps_per_sm": warps, **attrs}
        rows.append(row)
        print(f"{kernel} {label:>14} P={P}: {m:8.4f} ms {row['ns_per_step']:8.1f}"
              f" ns/step {row['ns_per_step_chain']:8.1f} ns/step/chain, "
              f"{warps} warps/SM"
              + "".join(f", {k} {v}" for k, v in attrs.items()), flush=True)
    by = {(r["kernel"], r["shape"], r["P"]): r for r in rows}
    label = {kernel: f"T={SHAPE[anyi][0]} S={SHAPE[anyi][1]}"
             for kernel, anyi in (("P5", False), ("P6", True))}
    summary = {"iters": iters, "shape": {k: list(SHAPE[k == "P6"])
                                         for k in label}}
    for kernel in label:
        # chains in flight per SM at which ns per step and chain stops
        # falling (P chains a thread, warps per SM as read)
        summary[f"{kernel}_stop_chains"] = _stop_point(
            {P: by[kernel, label[kernel], P]["ns_per_step_chain"]
             for P in PS})
    floor = by["P5", label["P5"], 1]
    summary["latency_floor_ms"] = floor["ms"]
    summary["latency_floor_ns_per_step"] = floor["ns_per_step"]
    summary["ops_bound_ms_P1"] = ops_bound_ms(1, iters)
    # P6's cost per step over P5: each warp of either runs the same 32
    # elements' P chains, and P6 adds the any to each step
    summary["P6_extra_ns_per_step"] = {
        P: by["P6", label["P6"], P]["ns_per_step"]
        - by["P5", label["P5"], P]["ns_per_step"] for P in PS}
    print(f"latency floor (P5, P=1, one warp a block): {iters} steps x "
          f"{floor['ns_per_step']:.1f} ns = {floor['ms']:.4f} ms, against "
          f"the card's operations bound {summary['ops_bound_ms_P1']:.6f} ms",
          flush=True)
    for k in ("shape", "P5_stop_chains", "P6_stop_chains",
              "P6_extra_ns_per_step"):
        print(f"{k}: {json.dumps(summary[k])}", flush=True)
    result = {"probe": "probe_interleave", "device":
              torch.cuda.get_device_name(0), "card": card, "rows": rows,
              "summary": summary}
    print(json.dumps(result))
    return result


def main():
    survey()


if __name__ == "__main__":
    main()

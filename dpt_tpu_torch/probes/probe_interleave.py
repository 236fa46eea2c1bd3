"""P5: P independent pointer-chase chains interleaved in one block.

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
tensors launch csrc/probes/interleave.cu (one block of 1024 threads, the P
chains unrolled in each thread; P in {1, 2, 4, 8}); CPU tensors run
`interleave_reference`, the same steps as torch ops (bit for bit on the
card: -fmad=false).  P6 (`probe_interleave_any`) is the same with the
tile's any(hit) added into the next index.

    python -m dpt_tpu_torch.probes.probe_interleave

times the kernel on the card at P = 1, 2, 4, 8 (the TPU probe's lines:
ms, ns per step, ns per step and chain, and beside them the least ns a
step and chain can take on the one SM that runs the block) and prints the
card's name and power limit and one JSON line.
"""

from __future__ import annotations

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
# The chain counts the kernel is built for (the TPU probe's main).
PS = (1, 2, 4, 8)
TIMED_LAUNCHES = 20
# Float operations of one step of one chain for one tile element: two slab
# tests of 25 (6 sub, 6 mul, 10 min / max, 3 compares) and the add.
OPS_PER_STEP = 51
# The H100 SXM's float32 rate without FMA (its 67e12 FLOP/s count an FMA as
# two operations; the kernel is built with -fmad=false).
F32_OPS_PER_S = 33.5e12


def sm_bound_ns():
    """Least ns of one step of one chain: the tile's OPS_PER_STEP x 1024
    operations at one SM's share of the card's float32 rate (one block runs
    on one SM)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 1024 * OPS_PER_STEP / (F32_OPS_PER_S / n_sm) * 1e9


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


def check_table(name, x, shape, device):
    if x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be float32 {list(shape)}, got "
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


def launch(nodes, rays, iters, any_in_index=False):
    """One kernel launch on the current stream: (acc [P, 1024], sink [P,
    3] int32).  Raises on a failed build or launch."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    P = rays.shape[0]
    if P not in PS:
        raise ValueError(f"the kernel is built for P in {PS}, got {P}")
    nodes = nodes.contiguous()
    if nodes.data_ptr() % 16:
        raise ValueError("nodes must be 16-byte aligned")
    out = torch.empty((P, rays.shape[2]), dtype=torch.float32,
                      device=rays.device)
    sink = torch.empty((P, 3), dtype=torch.int32, device=rays.device)
    lib = load_probe_library()
    err = lib.dpt_probe_interleave(
        nodes.data_ptr(), rays.contiguous().data_ptr(), P, iters,
        int(any_in_index), out.data_ptr(), sink.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    name = "interleave_any" if any_in_index else "interleave"
    check_launch(lib, name, err)
    probes.launch_counts[name] += 1
    return out, sink


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


def time_chains(any_in_index, label):
    """The probe's timing on the card at every P of PS: median device ms of
    TIMED_LAUNCHES launches over the 4 node tables in turn."""
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    tables = [torch.as_tensor(t, device=dev) for t in node_tables(rng)]
    rows = []
    bound = sm_bound_ns()
    for P in PS:
        packed = pack_rays(P, [torch.as_tensor(r, device=dev)
                               for r in ray_tiles(rng, P)])
        ms = statistics.median(probes.launch_ms(
            lambda n: launch(n, packed, ITERS, any_in_index),
            [(t,) for t in tables], n=TIMED_LAUNCHES))
        per = ms * 1e-3 / ITERS
        print(f"P={P}:  {ms:8.3f} ms  {per * 1e9:8.1f} ns/iter  "
              f"{per / P * 1e9:8.1f} ns/iter/chain  (SM bound {bound:.1f})",
              flush=True)
        rows.append({"P": P, "ms": ms, "ns_per_iter": per * 1e9,
                     "ns_per_iter_chain": per / P * 1e9,
                     "sm_bound_ns_per_iter_chain": bound})
    print(json.dumps({"probe": label, "device": torch.cuda.get_device_name(0),
                      "card": card, "iters": ITERS, "rows": rows}))


def main():
    time_chains(False, "probe_interleave")


if __name__ == "__main__":
    main()

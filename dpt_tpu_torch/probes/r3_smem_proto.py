"""P1: K1's nearest walk with its record table on chip, over a thread-block
cluster's distributed shared memory, and a leaf test with no call site.

Counterpart of `scripts/r3_smem_proto.py` (`smem_nearest`, pallas_call
:205, kernel `_kernel_smem`), which put every node record of the quad walk
in the TPU's scalar memory to learn whether the walk waits on reading its
records.  `pack_quad` numbers records breadth-first, so the top levels of
the tree are a prefix of the table: `smem_nearest(..., n_staged)` reads
the first `n_staged` records from shared memory and the rest, and every
leaf row, from global memory (csrc/probes/smem_walk.cu).  One block holds
BLOCK_RECORDS records (227 KB); a thread-block cluster of 2, 4 or 8 blocks
holds more, up to the whole table: the first REPLICATED records in every
block and the rest interleaved by id over the blocks (`home`, the rule the
kernel stages and reads by), in the smallest cluster that holds them
(`plan`).  Blocks of 128 threads (K1's) or 1024 in a cluster of one, 1024
in a larger cluster.  The kernel's leaf test takes 1 / det by the
hardware's approximate reciprocal and one Newton step, the IEEE division
only where that would differ, so its loop holds no call; `rcp_check` holds
that reciprocal against 1.0f / x on every float32 of its input range.  Its
(t, tri) are K1's lane walk's and the plain walk's bit for bit at every
prefix and cluster size: t is 1e30 (T_MAX) and tri 0 on a miss.  The TPU
probe votes one octant per tile where the port takes each ray's own, so
against it t is the same and tri the same away from equal-t ties.

`level_starts` finds the level boundaries from the child pointers, once,
on the host; `staged_prefixes` gives the prefixes the probe sweeps: 0 and
the end of every level, the last the whole table; `modes` the (prefix,
block) pairs it runs.

    python -m dpt_tpu_torch.probes.r3_smem_proto [--inputs 5] [--rounds 2]
        [--old DIR] [--sass]

builds the flagship tables (65,024 triangles, SAH leaf 8) and, on the
three streams of scripts/torch_walk_ablation.py (primary 1024², 2^18
incoherent rays and 126,621 of them), checks every mode and each of
FORCED against K1's lane kernel and the plain walk, runs `rcp_check`, then
times them beside K1's lane and group designs in turns, the order
reversed each round; prints the card's name and power limit, each mode's
registers, local bytes, resident blocks per SM, shared bytes and clusters
at once, one line per measurement and one JSON line.  FORCED are launches
in a larger cluster or with more replication than `plan` gives, which
part the cost of a cluster from that of its remote reads.  `--old DIR`
adds the one-block kernel of an older tree (DIR/smem_walk.cu, with
../traverse_common.cuh; its C interface (rays, tables, n_rays, n_staged,
block, outputs, stream)), e.g. unpacked by `git archive <commit>
dpt_tpu_torch/csrc | tar -x -C dpt_tpu_torch/_build/old`, built alone and
checked and timed in the same turns at each of its prefixes.  `--sass`
counts each build's leaf loop in the machine code
(`probes.sass.step_loops(..., innermost=True)`): its instructions a slot
test, reciprocals, calls, branches and convergence regions.  It uses the
repository's scripts/ (the ablation's streams), so it runs from a
checkout.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import statistics
import sys

import numpy as np
import torch

from dpt_tpu_torch import probes
from dpt_tpu_torch.kernels import quad

T_MAX = quad.T_MAX
RECORD_BYTES = 128
# The most shared memory one block may take on sm_90 (227 KB): the block's
# mbarrier (static) and its records (dynamic).
MAX_SHARED_BYTES = 232_448
BARRIER_BYTES = 8
BLOCK_RECORDS = (MAX_SHARED_BYTES - BARRIER_BYTES) // RECORD_BYTES
CLUSTERS = (1, 2, 4, 8)
# Records every block of a larger cluster holds: levels 0-4 of a full
# 4-wide tree (1 + 4 + 16 + 64 + 256), which every ray reads.
REPLICATED = 341
STREAMS = "primary:1024,incoherent:262144,incoherent:126621"
# Block shapes for a cluster of one: K1's 128 threads, and 1024, one block
# of which keeps K1's 1024 threads an SM at every prefix; a larger cluster
# takes 1024 (one block an SM at ~211 KB).
BLOCKS = (128, 1024)
CLUSTER_BLOCK = 1024
BLOCK = 128
# The leaf test's reciprocal takes 1.0 or |det| >= 1e-6 (the hard-coded
# eps of the parallel guard): `rcp_check` runs every float32 from this one
# up in magnitude, both signs.
RCP_LO = int(np.float32(1e-6).view(np.uint32))
# The one-block kernel's limit before clusters (the C launch of `--old`).
OLD_MAX_STAGED = MAX_SHARED_BYTES // RECORD_BYTES
# Levels 0-5 of a full 4-wide tree.
LEVEL5 = 4 * REPLICATED + 1
# Launches `main` times beside the modes, (n_staged, cluster, n_rep) in
# blocks of CLUSTER_BLOCK, each against the same prefix in one block:
# levels 0-4 all replicated in clusters of 2, 4 and 8 (a cluster, no
# remote read), and levels 0-5 over 4 blocks all replicated and with
# levels 0-4 replicated (the remote reads of level 5).
FORCED = ((REPLICATED, 2, REPLICATED), (REPLICATED, 4, REPLICATED),
          (REPLICATED, 8, REPLICATED), (LEVEL5, 4, LEVEL5),
          (LEVEL5, 4, REPLICATED))


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


def staged_prefixes(accel: quad.QuadAccel) -> list:
    """0, then the record count of levels 0..L for every level L: the last
    is the whole table."""
    return [0] + level_starts(accel)[1:]


def home(record: int, n_rep: int, cluster: int):
    """Where a block of a cluster of `cluster` finds staged record
    `record`, with the first `n_rep` records replicated: (None, record) for
    a replicated record (every block, at its id), else (block, slot): the
    other records interleaved by id, n_rep + k in block k % cluster at slot
    n_rep + k // cluster.  The kernel stages and reads by this rule."""
    k = record - n_rep
    if k < 0:
        return None, record
    return k % cluster, n_rep + k // cluster


def block_count(n_staged: int, n_rep: int, cluster: int, q: int = 0) -> int:
    """Records block q of the cluster holds (block 0 holds the most)."""
    return n_rep + -(-(n_staged - n_rep - q) // cluster)


def plan(n_staged: int):
    """(cluster, n_rep) for `n_staged` records: one block while they fit
    (all of them in it), else the smallest cluster of CLUSTERS whose
    blocks hold REPLICATED records each (fewer only where that is the
    difference between fitting and not) and an interleaved share.  Raises
    ValueError beyond 8 blocks' shared memory."""
    if n_staged < 0 or n_staged > max(CLUSTERS) * BLOCK_RECORDS:
        raise ValueError(f"n_staged {n_staged} does not fit in the shared "
                         f"memory of {max(CLUSTERS)} blocks "
                         f"({max(CLUSTERS) * BLOCK_RECORDS} records)")
    if n_staged <= BLOCK_RECORDS:
        return 1, n_staged
    for cluster in CLUSTERS[1:]:
        for n_rep in range(min(REPLICATED, n_staged), -1, -1):
            if block_count(n_staged, n_rep, cluster) <= BLOCK_RECORDS:
                return cluster, n_rep
    raise AssertionError("unreachable: 8 blocks hold the table unreplicated")


def modes(accel: quad.QuadAccel) -> list:
    """The (n_staged, block) pairs the probe runs: every staged prefix, in
    each of BLOCKS where one block holds it, else in CLUSTER_BLOCK."""
    return [(s, b) for s in staged_prefixes(accel)
            for b in (BLOCKS if plan(s)[0] == 1 else (CLUSTER_BLOCK,))]


def shape(n_staged: int, block=None, cluster=None, n_rep=None):
    """(block, cluster, n_rep) of a launch: `plan`'s cluster and
    replication unless given (a larger cluster, or other replication, that
    still fits), block 128 for a cluster of one and 1024 for more unless
    given.  Raises ValueError for a shape the kernel does not take."""
    least, rep = plan(n_staged)
    cluster = least if cluster is None else cluster
    if cluster not in CLUSTERS or cluster < least:
        raise ValueError(f"cluster must be one of {CLUSTERS} and at least "
                         f"{least} for n_staged {n_staged}, got {cluster}")
    if n_rep is None:
        n_rep = n_staged if cluster == 1 else min(rep if cluster == least
                                                  else REPLICATED, n_staged)
    if not 0 <= n_rep <= n_staged or (cluster == 1 and n_rep != n_staged):
        raise ValueError(f"n_rep {n_rep} for n_staged {n_staged} in a "
                         f"cluster of {cluster}")
    if block_count(n_staged, n_rep, cluster) > BLOCK_RECORDS:
        raise ValueError(f"{block_count(n_staged, n_rep, cluster)} records "
                         f"a block exceed {BLOCK_RECORDS}")
    if block is None:
        block = BLOCK if cluster == 1 else CLUSTER_BLOCK
    if block not in (BLOCKS if cluster == 1 else (CLUSTER_BLOCK,)):
        raise ValueError(f"block {block} in a cluster of {cluster}")
    return block, cluster, n_rep


def smem_nearest_reference(origin, direction, accel: quad.QuadAccel):
    """Plain PyTorch walk (K1's, kernels/quad.py): (t [R] f32, 1e30 on a
    miss; tri [R] int32, 0 on a miss)."""
    md = torch.zeros((origin.shape[0],), dtype=torch.float32,
                     device=origin.device)
    return quad._walk_reference(origin, direction, md, accel, False,
                                quad.KERNEL_STACK)


def grid(n_rays: int, block: int, cluster: int) -> int:
    """Blocks that cover `n_rays` rays once in whole clusters."""
    return cluster * -(-n_rays // (cluster * block))


def launch(origin, direction, accel: quad.QuadAccel, n_staged: int,
           block=None, cluster=None, n_rep=None):
    """One kernel launch on the current stream in the shape `shape` gives:
    (t, tri).  Raises on a failed build or launch."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    block, cluster, n_rep = shape(n_staged, block, cluster, n_rep)
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
        *(x.data_ptr() for x in (*rays, *tables)), R, n_staged, n_rep, block,
        cluster, grid(R, block, cluster), out_t.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, "smem_walk", err)
    probes.launch_counts["smem_walk"] += 1
    return out_t, out_i


def smem_nearest(origin, direction, accel: quad.QuadAccel, n_staged=0,
                 block=None):
    """Nearest hit through the 4-wide walk with the first `n_staged`
    records in shared memory (over a cluster where one block cannot hold
    them: `plan`), in blocks of `block` threads (`shape`): (t [R] f32,
    T_MAX on a miss; tri [R] int32, 0 on a miss).  CUDA tensors launch the
    kernel; CPU tensors take the plain walk, which `n_staged` and `block`
    do not change."""
    quad._check_inputs(origin, direction, None, accel)
    need = 3 * accel.max_depth + 2
    if need > quad.KERNEL_STACK:
        raise ValueError(f"quad BVH depth {accel.max_depth} needs a stack of "
                         f"{need}, the kernel holds {quad.KERNEL_STACK}")
    if not 0 <= n_staged <= accel.n_wide:
        raise ValueError(f"n_staged must be in [0, {accel.n_wide}], got "
                         f"{n_staged}")
    block = shape(n_staged, block)[0]
    if origin.is_cuda:
        return launch(origin, direction, accel, n_staged, block)
    if origin.device.type != "cpu":
        raise ValueError(f"unsupported device {origin.device}")
    return smem_nearest_reference(origin, direction, accel)


def attributes(n_staged: int, block=None, cluster=None, n_rep=None) -> dict:
    """Registers and local bytes per thread, resident blocks per SM, shared
    bytes a block and clusters the card holds at once, of a launch in the
    shape `shape` gives."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    block, cluster, n_rep = shape(n_staged, block, cluster, n_rep)
    vals = [ctypes.c_int(0) for _ in range(5)]
    err = load_probe_library().dpt_quad_traverse_smem_attrs(
        n_staged, n_rep, block, cluster, *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"smem_walk attributes: cudaError {err}")
    return dict(zip(("num_regs", "local_bytes", "blocks_per_sm",
                     "smem_bytes", "max_clusters"), (v.value for v in vals)))


def rcp_check(device=None) -> dict:
    """The leaf test's reciprocal against 1.0f / x on the card, on every
    float32 x with RCP_LO <= |x| bits (both signs, inf and NaN included):
    {"differing", "tested", "fast", "expected"} (fast: the inputs its fast
    path took; expected: the floats of the range)."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    dev = torch.device("cuda") if device is None else torch.device(device)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    lib = load_probe_library()
    err = lib.dpt_smem_walk_rcp_check(
        RCP_LO, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, "smem_walk rcp_check", err)
    d, n, f = (int(v) for v in out.cpu())
    return {"differing": d, "tested": n, "fast": f,
            "expected": 2 * (0x80000000 - RCP_LO)}


def old_launcher(lib_path):
    """launch(origin, direction, accel, n_staged, block) -> (t, tri) of an
    older tree's one-block smem_walk.cu built at `lib_path`."""
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.dpt_quad_traverse_smem
    fn.argtypes = [p, p, p, p, i, i, i, p, p, p]
    fn.restype = i

    def run(o, d, accel, n_staged, block):
        R = o.shape[0]
        out_t = torch.empty((R,), dtype=torch.float32, device=o.device)
        out_i = torch.empty((R,), dtype=torch.int32, device=o.device)
        err = fn(o.data_ptr(), d.data_ptr(), accel.nodes_flat.data_ptr(),
                 accel.tris.data_ptr(), R, n_staged, block, out_t.data_ptr(),
                 out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old smem_walk launch: cudaError {err}")
        return out_t, out_i

    return run


def sources(csrc_probes: pathlib.Path) -> list:
    """smem_walk.cu of a tree's csrc/probes and the headers it may
    include."""
    return [p for p in (csrc_probes / "smem_walk.cu",
                        csrc_probes / "probe_common.cuh",
                        csrc_probes.parent / "traverse_common.cuh")
            if p.exists()]


def leaf_loops(lib_path, kernel: str) -> dict:
    """{"T/S" or "T": counts} for each instantiation of a library's
    smem_walk kernel (regex `kernel`, its template arguments as groups):
    the leaf loop (`sass.step_loops(..., innermost=True)`: the innermost
    loop over the most leaf-row loads) and its instructions a slot test
    (the loop's over 8), by opcode, with its reciprocals (MUFU.RCP), calls,
    branches and convergence regions (BSSY / BSYNC)."""
    from dpt_tpu_torch.probes import sass

    out = {}
    for m, ops in sass.step_loops(sass.dump(lib_path), kernel,
                                  innermost=True):
        count = collections.Counter(o.split(".")[0] for o in ops)
        out["/".join(m.groups())] = {
            "loop_instructions": len(ops),
            "per_slot_test": len(ops) / 8,
            "loads": sum(o.startswith("LDG") for o in ops),
            "rcp": sum(o.startswith("MUFU.RCP") for o in ops),
            "calls": count["CALL"], "branches": count["BRA"],
            "convergence": count["BSSY"] + count["BSYNC"],
            "by_opcode": dict(count.most_common(12)),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", default=STREAMS)
    ap.add_argument("--inputs", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--old", type=pathlib.Path, default=None)
    ap.add_argument("--sass", action="store_true")
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
    starts = level_starts(accel)
    kept = modes(accel)
    print(f"records {accel.n_wide}, level starts {starts}, modes "
          f"(n_staged, block, cluster, n_rep) "
          f"{[(s, *shape(s, b)) for s, b in kept]}", flush=True)
    attrs = {(s, b): attributes(s, b) for s, b in kept}
    for (s, b), a in attrs.items():
        print(f"smem_walk n_staged={s} block {b}: " + json.dumps(a),
              flush=True)
    print("quad_traverse lane/group nearest: " + json.dumps({
        d: build.kernel_attributes(e, False)
        for d, e in quad._EXPORTS.items()}), flush=True)
    rcp = rcp_check()
    print(f"rcp_check: {json.dumps(rcp)}", flush=True)
    if rcp["differing"] or rcp["tested"] != rcp["expected"]:
        raise RuntimeError(f"the leaf test's reciprocal differs from 1.0f / "
                           f"x: {rcp}")

    def k1(design):
        return lambda o, d: quad._launch(o, d, None, accel, False, design)

    runs = {f"k1_{d}": k1(d) for d in ("lane", "group")}
    runs.update({f"p1_{b}_{s}": (lambda s, b: lambda o, d: launch(
        o, d, accel, s, b))(s, b) for s, b in kept})
    if args.old is not None:
        old = old_launcher(build.build("libdpt_smem_walk_old",
                                       sources(args.old)))
        runs.update({f"old_{b}_{s}": (lambda s, b: lambda o, d: old(
            o, d, accel, s, b))(s, b) for s, b in kept
            if s <= OLD_MAX_STAGED and shape(s, b)[1] == 1})
    for n, cl, rep in FORCED:
        runs[f"p1_{CLUSTER_BLOCK}_{n}_S{cl}_R{rep}"] = (
            lambda n, cl, rep: lambda o, d: launch(
                o, d, accel, n, CLUSTER_BLOCK, cl, rep))(n, cl, rep)
    for sname, (inputs, plain, info) in streams.items():
        print(f"{sname}: " + json.dumps(info["nearest"]), flush=True)
        for (o, d, _), (pt, pi, _) in zip(inputs, plain):
            kt, ki = k1("lane")(o, d)
            for r, call in runs.items():
                st, si = call(o, d)
                torch.cuda.synchronize()
                if not (torch.equal(st, pt) and torch.equal(si, pi)
                        and torch.equal(st, kt) and torch.equal(si, ki)):
                    raise RuntimeError(f"{sname}: {r} differs from K1 lane "
                                       "or the plain walk")
        print(f"{sname}: every mode equals K1 lane and the plain walk on "
              f"{len(inputs)} inputs", flush=True)
    res = {s: {r: [] for r in runs} for s in streams}
    names = list(runs)
    for rnd in range(args.rounds):
        for sname, (inputs, _, _) in streams.items():
            for r in names if rnd % 2 == 0 else names[::-1]:
                ms = statistics.fmean(probes.launch_ms(
                    runs[r], [x[:2] for x in inputs], n=2 * len(inputs)))
                res[sname][r].append(ms)
                print(f"round {rnd} {sname} {r}: {ms:.4f} ms", flush=True)
    out = {"probe": "r3_smem_proto", "device": torch.cuda.get_device_name(0),
           "card": card, "level_starts": starts,
           "modes": [(s, *shape(s, b)) for s, b in kept], "forced": FORCED,
           "attributes": {f"{s}/{b}": a for (s, b), a in attrs.items()},
           "rcp_check": rcp,
           "streams": {s: v[2]["nearest"] for s, v in streams.items()},
           "kernel_ms": res}
    if args.sass:
        lib = build.build("libdpt_probes", build._probe_sources())
        out["sass"] = {"tree": leaf_loops(
            lib, r"smem_walk_kernelILi(\d+)ELi(\d+)E")}
        if args.old is not None:
            out["sass"]["old"] = leaf_loops(
                build.library_path("libdpt_smem_walk_old", sources(args.old)),
                r"smem_walk_kernelILi(\d+)EE")
        for tree, loops in out["sass"].items():
            for name, c in loops.items():
                print(f"[sass] {tree} {name}: {c['per_slot_test']:.1f} "
                      f"instructions a slot test ({c['loop_instructions']} "
                      f"in the leaf loop, {c['loads']} LDG), {c['rcp']} "
                      f"MUFU.RCP, {c['calls']} CALL, {c['branches']} BRA, "
                      f"{c['convergence']} BSSY/BSYNC; "
                      + ", ".join(f"{o} {n}" for o, n in
                                  c["by_opcode"].items()), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

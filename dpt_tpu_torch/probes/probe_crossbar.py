"""P4: the per-lane lookup primitives, each a loop over one [8, 128] tile.

Counterpart of `scripts/probe_crossbar.py` (which runs everything when
imported; here the work is in `main`), whose five Pallas kernels priced
Mosaic's lookups, run by `run_kernel` :30 (pallas_call :33) or `go_d` :109
(pallas_call :110) for ITERS = 2000 steps, each a CUDA kernel of
csrc/probes/crossbar.cu:

  - `sublane_gather(x, sub, iters)` (`kern_a` :48): acc[r, c] += x[(sub[r,
    c] + k) % 8, c];
  - `lane_gathers(x, idx, K, iters)` (`kern_b` :64, K = 1, 4, 12): for k <
    iters // K and q = 0..K-1 in order, acc[r, c] += (x + q)[r, (idx[r, c]
    + k) % 128];
  - `fused_lookup(x, lane, srow, iters)` (`kern_c` :80): s = (srow[r, c] +
    k) % 8, acc[r, c] += x[s, (lane[s, c] + k) % 128] (a lane gather, then
    a row gather of its result);
  - `row_blocks(tab, rows)` (`kern_d` :101): acc[r, c] += tab[rows[k] * 8 +
    r, c] for k < len(rows), tab f32 [4096, 128] (2 MB), rows int32 in [0,
    511) (a row block out of range starts where JAX's `pl.ds` would);
  - `vector_ops(x, iters)` (`kern_e` :127): v = x + acc, then 70 times v =
    v * 1.0001 + 0.5, acc = v.

x is f32 [8, 128], sub / idx / lane / srow int32 [8, 128]; % is floor mod.
CUDA tensors launch the kernel; CPU tensors run the `*_reference`
functions, the same steps as torch ops (bit for bit on the card).

B runs in 8 blocks of 128 threads (a tile row each) and C in 32 blocks of
one warp, each warp reading a table copied once a shared-memory bank, so
that every lookup is one wavefront whatever the indices; `index_patterns`
makes the index tiles the kernels are timed on (seeded, one bank,
identity).  A runs in 32 blocks of one warp on B and C's step loop, each
lane reading its own column of x's 8 rows (always its bank).  D runs in
32 blocks of one warp, each taking 32 columns of one tile row: a step's
128-byte slice of the table arrives by a bulk copy into a shared-memory
ring, so the table's base must be 16-byte aligned on the card.

    python -m dpt_tpu_torch.probes.probe_crossbar

prints the TPU probe's lines on the card (ns a gather, step or load of each
kernel beside the bound of one SM doing all its work, and beside its
chain's latency bound at the card's clocks a dependent operation, which
`op_cycles` reads from a bare chain apart from the kernels' code, with E's
own clocks an operation from `chain_cycles`), the card's name and power
limit and one JSON line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dpt_tpu_torch import probes

ITERS = 2000
LANES = 128
ROWS = 8
TABLE_ROWS = 4096
ROW_BLOCKS = 511  # rows[k] is drawn from [0, 511)
KS = (1, 4, 12)
MATH_OPS = 70
MUL, ADD = 1.0001, 0.5
# E's dependent operations a step of each element: the add of x, then 70
# multiplies and adds.
CHAIN_OPS = 2 * MATH_OPS + 1
# The bare chain that reads the card's clocks a dependent operation
# (`op_cycles`): OP_CHAIN_STEPS steps of OP_CHAIN_PAIRS multiply-adds.
OP_CHAIN_STEPS = 125
OP_CHAIN_PAIRS = 512  # crossbar.cu kChainPairs
TIMED_LAUNCHES = 20
# The index tiles B and C are timed on: the TPU probe's draw, a tile
# whose warps read one bank at every step, and the identity.
PATTERNS = ("seeded", "one_bank", "identity")
# Each element's operations a step, as the TPU probe spells them: an index
# add and floor mod (two int32 operations) for each lookup index, a
# shared-memory word for each lookup, a float add for each sum.  D's row
# block start is the same for the whole tile (its 4 KB come from L2, which
# no pipe here counts); E is 70 multiply adds and the add of x.
STEP_OPS = {
    "sublane": {"i32": 2, "lds": 1, "f32": 1},
    "fused": {"i32": 4, "lds": 2, "f32": 1},
    "rows": {"f32": 1},
    "math": {"f32": CHAIN_OPS},
}


def lanes_step_ops(K):
    """B's step needs one lookup, not K: (x + q)[j] is x[j] + q rounded,
    bit for bit, so the function is one word, its index and 2K float adds
    (the kernel keeps the TPU probe's K lookups, and is held to this)."""
    return {"i32": 2, "lds": 1, "f32": 2 * K}


def index_patterns(rng):
    """pattern -> {"idx", "lane", "srow"}, int32 [8, 128] numpy tiles (B
    takes idx, C lane and srow): "seeded", drawn as the TPU probe draws
    them (C takes idx as lane, as the probe does); "one_bank", where at
    every step a warp's 32 lanes read distinct words of one bank of an
    uncopied table (B: 4 words of its row, (idx + k) % 32 the same for all
    lanes; C: 32 words of x, 8 rows by srow = c % 8 times 4 columns); and
    "identity" (idx = lane = c, srow = r), a warp's reads consecutive."""
    rows, cols = np.meshgrid(np.arange(ROWS), np.arange(LANES),
                             indexing="ij")
    # 32 banks of a word: column c is lane c % 32 of warp c // 32 of its row
    one_bank = (32 * (cols % 32 // 8) + 5 * (cols // 32) + 3) % LANES
    seeded = rng.integers(0, LANES, (ROWS, LANES), dtype=np.int32)
    tiles = {
        "seeded": (seeded, rng.integers(0, ROWS, (ROWS, LANES))),
        "one_bank": (one_bank, cols % ROWS),
        "identity": (cols, rows),
    }
    return {name: {"idx": t.astype(np.int32), "lane": t.astype(np.int32),
                   "srow": s.astype(np.int32)}
            for name, (t, s) in tiles.items()}


def sublane_gather_reference(x, sub, iters):
    acc = torch.zeros_like(x)
    for k in range(iters):
        acc = acc + torch.gather(x, 0, torch.remainder(sub + k, ROWS).long())
    return acc


def lane_gathers_reference(x, idx, K, iters):
    xq = [x + float(q) for q in range(K)]
    acc = torch.zeros_like(x)
    for k in range(iters):
        j = torch.remainder(idx + k, LANES).long()
        for q in range(K):
            acc = acc + torch.gather(xq[q], 1, j)
    return acc


def fused_lookup_reference(x, lane, srow, iters):
    acc = torch.zeros_like(x)
    for k in range(iters):
        g1 = torch.gather(x, 1, torch.remainder(lane + k, LANES).long())
        acc = acc + torch.gather(g1, 0, torch.remainder(srow + k, ROWS).long())
    return acc


def row_starts(rows, n_rows):
    """Each step's first table row: JAX's start of pl.ds(rows[k] * 8, 8)
    (rows * 8 wraps in int32 as in JAX), on the rows' device."""
    return probes.dyn_start(rows * ROWS, n_rows, ROWS)


def row_blocks_reference(tab, rows):
    starts = row_starts(rows, tab.shape[0]).long()
    offs = torch.arange(ROWS, device=tab.device)
    blocks = tab.index_select(0, (starts[:, None] + offs).reshape(-1))
    blocks = blocks.reshape(-1, ROWS, tab.shape[1])
    acc = torch.zeros((ROWS, tab.shape[1]), dtype=tab.dtype,
                      device=tab.device)
    for k in range(rows.shape[0]):
        acc = acc + blocks[k]
    return acc


def vector_ops_reference(x, iters):
    acc = torch.zeros_like(x)
    for _ in range(iters):
        v = x + acc
        for _ in range(MATH_OPS):
            v = v * MUL + ADD
        acc = v
    return acc


def _tiles(iters, x, *index_tiles):
    probes.check_tensor("x", x, torch.float32, (ROWS, LANES))
    for t in index_tiles:
        probes.check_tensor("index tile", t, torch.int32, (ROWS, LANES))
    probes.check_steps(iters)
    return probes.on_device(x, *index_tiles)


def _launch(name, x, *args):
    return probes.launch_kernel(
        name, torch.empty_like(x),
        *(a.contiguous() if isinstance(a, torch.Tensor) else a
          for a in (x, *args)))


def sublane_gather(x, sub, iters=ITERS):
    """[8, 128] f32: the sum over k < iters of x[(sub + k) % 8, c]."""
    if _tiles(iters, x, sub) == "cpu":
        return sublane_gather_reference(x, sub, iters)
    return _launch("crossbar_sublane", x, sub, iters)


def lane_gathers(x, idx, K, iters=ITERS):
    """[8, 128] f32: iters // K steps of K lane gathers from x + q."""
    if K not in KS:
        raise ValueError(f"the kernel is built for K in {KS}, got {K}")
    if _tiles(iters, x, idx) == "cpu":
        return lane_gathers_reference(x, idx, K, iters // K)
    return _launch("crossbar_lanes", x, idx, K, iters // K)


def fused_lookup(x, lane, srow, iters=ITERS):
    """[8, 128] f32: the sum over k of x[s, (lane[s, c] + k) % 128], s =
    (srow + k) % 8."""
    if _tiles(iters, x, lane, srow) == "cpu":
        return fused_lookup_reference(x, lane, srow, iters)
    return _launch("crossbar_fused", x, lane, srow, iters)


def row_blocks(tab, rows):
    """[8, 128] f32: the sum over k of the row block tab[rows[k] * 8 :
    rows[k] * 8 + 8].  On the card tab's base must be 16-byte aligned (a
    ValueError otherwise, before any launch)."""
    probes.check_tensor("tab", tab, torch.float32, (None, LANES))
    probes.check_tensor("rows", rows, torch.int32, (None,))
    if not ROWS <= tab.shape[0] < 2**31 // LANES:
        raise ValueError(f"tab needs {ROWS} to {2**31 // LANES - 1} rows (the "
                         f"kernel's int32 offsets), got {tab.shape[0]}")
    probes.check_steps(rows.shape[0])
    if probes.on_device(tab, rows) == "cpu":
        return row_blocks_reference(tab, rows)
    tab = tab.contiguous()
    if tab.data_ptr() % 16:
        raise ValueError("tab's base must be 16-byte aligned (the kernel "
                         "bulk-copies its rows), got address "
                         f"{tab.data_ptr():#x}")
    return probes.launch_kernel(
        "crossbar_rows", torch.empty((ROWS, LANES), dtype=torch.float32,
                                     device=tab.device),
        tab, tab.shape[0], rows.contiguous(), rows.shape[0])


def vector_ops(x, iters=ITERS):
    """[8, 128] f32: iters steps of v = x + acc and 70 multiply-adds."""
    if _tiles(iters, x) == "cpu":
        return vector_ops_reference(x, iters)
    return _launch("crossbar_math", x, iters)


def chain_cycles(x, iters=ITERS):
    """(clocks a dependent operation of E takes on the card, the 32
    elements it computed): E's first warp launched alone (one block of 32
    threads, one SM), its SM clocks from before the loop to after its store
    (read by the kernel) over iters x CHAIN_OPS."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    _tiles(iters, x)
    if not x.is_cuda:
        raise ValueError("chain_cycles needs a CUDA tensor")
    x = x.contiguous()
    out = torch.zeros_like(x)
    cycles = torch.zeros(1, dtype=torch.int64, device=x.device)
    lib = load_probe_library()
    err = lib.dpt_probe_crossbar_math_cycles(
        x.data_ptr(), iters, out.data_ptr(), cycles.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "crossbar_math_cycles", err)
    probes.launch_counts["crossbar_math"] += 1
    return int(cycles) / (iters * CHAIN_OPS), out.reshape(-1)[:32]


def op_chain_reference(x, steps=OP_CHAIN_STEPS):
    """The bare chain's 32 ends: steps x OP_CHAIN_PAIRS of v = v * MUL +
    ADD from x's first 32 elements, each operation rounded."""
    v = x.reshape(-1)[:32]
    for _ in range(steps * OP_CHAIN_PAIRS):
        v = v * MUL + ADD
    return v


def op_cycles(x):
    """(the card's clocks a dependent float operation, the 32 chain ends):
    one warp (one SM) of bare chains of OP_CHAIN_STEPS x OP_CHAIN_PAIRS
    multiply-adds from x's first 32 elements, apart from E's code; its SM
    clocks from before the loop to after its store (read by the kernel)
    over the chain's operations.  A timing instrument: no launch count."""
    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    _tiles(1, x)
    if not x.is_cuda:
        raise ValueError("op_cycles needs a CUDA tensor")
    x = x.contiguous()
    out = torch.zeros(32, dtype=torch.float32, device=x.device)
    cycles = torch.zeros(1, dtype=torch.int64, device=x.device)
    lib = load_probe_library()
    err = lib.dpt_probe_crossbar_op_cycles(
        x.data_ptr(), OP_CHAIN_STEPS, out.data_ptr(), cycles.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "crossbar_op_cycles", err)
    return int(cycles) / (OP_CHAIN_STEPS * OP_CHAIN_PAIRS * 2), out


def inputs(rng, iters=ITERS):
    """The TPU probe's inputs, drawn as it draws them (normal floats,
    uniform indices) from a numpy generator: x [8, 128], idx [8, 128] in
    [0, 128), sub [8, 128] in [0, 8), tab [4096, 128], rows [iters] in [0,
    511)."""
    return {
        "x": rng.normal(size=(ROWS, LANES)).astype(np.float32),
        "idx": rng.integers(0, LANES, (ROWS, LANES), dtype=np.int32),
        "sub": rng.integers(0, ROWS, (ROWS, LANES), dtype=np.int32),
        "tab": rng.normal(size=(TABLE_ROWS, LANES)).astype(np.float32),
        "rows": rng.integers(0, ROW_BLOCKS, (iters,), dtype=np.int32),
    }


def launches(a, iters=ITERS):
    """kernel -> `probes.Launch` at the inputs `a` (tensors, as `inputs`
    draws them) and ITERS = `iters`, each through its public wrapper as the
    TPU probe runs it (C takes idx as `lane` and sub as `srow`, as the probe
    does; D the first `iters` rows).  Each loop's chain: one dependent
    add a step of each element's sum (B: K), E's CHAIN_OPS."""
    tile = ROWS * LANES
    x, idx, sub, tab = a["x"], a["idx"], a["sub"], a["tab"]
    rows = a["rows"][:iters]
    n_blocks = int(torch.unique(row_starts(rows, tab.shape[0])).numel())

    def ops(step_ops, steps):
        return {k: n * tile * steps for k, n in step_ops.items()}

    return {
        "crossbar_sublane": probes.Launch(
            "a) axis-0 [8,128] gather",
            lambda: sublane_gather(x, sub, iters),
            lambda: sublane_gather_reference(x, sub, iters),
            iters, ops(STEP_OPS["sublane"], iters), 12 * tile, 1),
        **{f"crossbar_lanes_K{K}": probes.Launch(
            f"b) {K:2d} axis-1 gathers/iter",
            lambda K=K: lane_gathers(x, idx, K, iters),
            lambda K=K: lane_gathers_reference(x, idx, K, iters // K),
            iters // K, ops(lanes_step_ops(K), iters // K), 12 * tile, K)
           for K in KS},
        "crossbar_fused": probes.Launch(
            "c) fused 1024-lookup",
            lambda: fused_lookup(x, idx, sub, iters),
            lambda: fused_lookup_reference(x, idx, sub, iters),
            iters, ops(STEP_OPS["fused"], iters), 16 * tile, 1),
        # the distinct row blocks read, the rows, the output
        "crossbar_rows": probes.Launch(
            "d) dyn [8,128] row-block load",
            lambda: row_blocks(tab, rows),
            lambda: row_blocks_reference(tab, rows),
            iters, ops(STEP_OPS["rows"], iters),
            4 * tile * n_blocks + 4 * iters + 4 * tile, 1),
        "crossbar_math": probes.Launch(
            "e) 70 fused vector ops",
            lambda: vector_ops(x, iters),
            lambda: vector_ops_reference(x, iters),
            iters, ops(STEP_OPS["math"], iters), 8 * tile, CHAIN_OPS),
    }


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    a = {k: torch.as_tensor(v, device=dev)
         for k, v in inputs(np.random.default_rng(0)).items()}
    lns = launches(a)
    cycles, ends = op_cycles(a["x"])
    if not torch.equal(ends.cpu(), op_chain_reference(a["x"].cpu())):
        sys.exit("the bare chain differs from its plain version")
    own, first = chain_cycles(a["x"])
    if not torch.equal(first, lns["crossbar_math"].call().reshape(-1)[:32]):
        sys.exit("e) its first warp alone differs from the whole tile's")
    print(f"the card: {cycles:.4f} clocks a dependent operation (a bare "
          f"chain, one warp); e) one warp alone: {own:.4f} clocks an "
          "operation of its own chain", flush=True)
    timed = probes.time_launches(lns, TIMED_LAUNCHES, cycles)
    timed["crossbar_math"]["own_cycles_per_op"] = own
    for K in KS:  # the TPU probe's ns a gather
        m = timed[f"crossbar_lanes_K{K}"]
        m["ns_per_gather"] = m["ns_per_step"] / K
    probes.print_launches("probe_crossbar", lns, timed, card, iters=ITERS)


if __name__ == "__main__":
    main()

"""P3: gather throughput, in torch indexing and inside one block.

Counterpart of `scripts/attic/probe_gather.py`:

  - `xla_gather_probe` :29 (XLA, no kernel): `table[idx].sum(-1)` of R =
    2^20 random rows of an [N, W] f32 table, N in 2^14, 2^17, 2^20 and W
    in 8, 16, and `chase` :52, 32 chained steps idx = (table[idx][:, 0] +
    i) % N over an [2^17, 8] int32 table.  XLA computed them outside any
    kernel, so here they are torch indexing (`xla_gather`, `chase`), timed
    on the card as the TPU probe prints them (ms, GB/s, Mgather/s).
  - `pallas_gather_probe` :64, two Pallas kernels, each ported as a CUDA
    kernel of csrc/probes/crossbar.cu, beside P4's, whose designs they
    share:
      - `axis1_gather(x, idx, iters)` (`kern` :66, pallas_call :82): x f32
        and idx int32 [8, 128], acc[r, c] += x[r, (idx[r, c] + k) % 128]
        for k < iters (the TPU probe's 1000).  This is P4-b at K = 1, so
        it launches P4-b's `lanes_kernel<1>`: 8 blocks of 128 threads, a
        tile row each, the row copied once a shared-memory bank (its table
        holds x + 0.0f, which a sum from +0 cannot tell from x);
      - `axis0_gather(x, idx, iters)` (`kern0` :98, pallas_call :113): x
        f32 and idx int32 [64, 128], acc[r, c] += x[(idx[r, c] + k) % 64,
        c] for k < iters (100).  `column_kernel`: 256 blocks of one warp,
        each lane's column of the 64 rows in its own bank, a group of 32
        steps read from one base.
    % is floor mod, so any int32 index is taken (the TPU probe's are in
    [0, 128) and [0, 64)).  CUDA tensors launch the kernel; CPU tensors
    run the `*_reference` functions (bit for bit on the card).
    `row_patterns` makes the [64, 128] index tiles P3-b is timed on
    (P3-a takes `probe_crossbar.index_patterns`' idx).

    python -m dpt_tpu_torch.probes.probe_gather

prints the TPU probe's lines on the card (the torch gathers, then ns a
gather of each kernel beside the bound of one SM doing all its work and
its chain's latency bound at the card's clocks a dependent operation,
`probe_crossbar.op_cycles`), the card's name and power limit and one JSON
line.  scripts/torch_crossbar_shapes.py times both kernels per index tile
and at 0 steps beside an older tree's.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dpt_tpu_torch import probes
from dpt_tpu_torch.probes import probe_crossbar

LANES = 128
ITERS_AXIS1 = 1000
ITERS_AXIS0 = 100
ROWS_AXIS0 = 64
# The torch gathers of `xla_gather_probe`.
GATHER_ROWS = 1 << 20
GATHER_TABLES = ((1 << 14, 1 << 17, 1 << 20), (8, 16))
CHASE_TABLE = (1 << 17, 8)
CHASE_STEPS = 32
TIMED_LAUNCHES = 20
# Each element's step: the index add and floor mod (two int32 operations),
# one shared-memory word, one float add.
STEP_OPS = {"i32": 2, "lds": 1, "f32": 1}


def axis1_gather_reference(x, idx, iters):
    acc = torch.zeros_like(x)
    for k in range(iters):
        j = torch.remainder(idx + k, LANES).long()
        acc = acc + torch.gather(x, 1, j)
    return acc


def axis0_gather_reference(x, idx, iters):
    acc = torch.zeros_like(x)
    for k in range(iters):
        j = torch.remainder(idx + k, x.shape[0]).long()
        acc = acc + torch.gather(x, 0, j)
    return acc


def _gather(name, reference, x, idx, rows, iters):
    probes.check_tensor("x", x, torch.float32, (rows, LANES))
    probes.check_tensor("idx", idx, torch.int32, (rows, LANES))
    probes.check_steps(iters)
    if probes.on_device(x, idx) == "cpu":
        return reference(x, idx, iters)
    return probes.launch_kernel(name, torch.empty_like(x), x.contiguous(),
                                idx.contiguous(), iters)


def axis1_gather(x, idx, iters=ITERS_AXIS1):
    """[8, 128] f32: the sum over k < iters of x[r, (idx + k) % 128]."""
    return _gather("gather_axis1", axis1_gather_reference, x, idx, 8, iters)


def axis0_gather(x, idx, iters=ITERS_AXIS0):
    """[64, 128] f32: the sum over k < iters of x[(idx + k) % 64, c]."""
    return _gather("gather_axis0", axis0_gather_reference, x, idx,
                   ROWS_AXIS0, iters)


def inputs(rng):
    """The TPU probe's kernel inputs, drawn as it draws them (normal x,
    uniform indices) from a numpy generator: (x [8, 128], idx [8, 128] in
    [0, 128), x0 [64, 128], idx0 [64, 128] in [0, 64))."""
    return (rng.normal(size=(8, LANES)).astype(np.float32),
            rng.integers(0, LANES, (8, LANES), dtype=np.int32),
            rng.normal(size=(ROWS_AXIS0, LANES)).astype(np.float32),
            rng.integers(0, ROWS_AXIS0, (ROWS_AXIS0, LANES), dtype=np.int32))


def row_patterns(rng):
    """pattern -> int32 [64, 128] numpy tile of P3-b's indices, named as
    `probe_crossbar.PATTERNS`: "seeded", drawn as the TPU probe draws them;
    "one_bank", where at every step a warp's 32 lanes (32 columns of one
    row) read one row, which a copy holding each column whole (column c at
    c * 64) would put on one bank; and "identity" (idx0 = r)."""
    rows, cols = np.meshgrid(np.arange(ROWS_AXIS0), np.arange(LANES),
                             indexing="ij")
    tiles = {
        "seeded": rng.integers(0, ROWS_AXIS0, (ROWS_AXIS0, LANES)),
        "one_bank": (7 * rows + 5 * (cols // 32) + 3) % ROWS_AXIS0,
        "identity": rows,
    }
    return {name: t.astype(np.int32) for name, t in tiles.items()}


def launches(x, idx, x0, idx0, iters=None):
    """The two kernels' `probes.Launch` records at the inputs (tensors),
    each at the TPU probe's steps (1000, 100) or at `iters`; each
    element's sum is a chain of one dependent add a step."""
    out = {}
    for name, fn, ref, args, label, steps in (
            ("gather_axis1", axis1_gather, axis1_gather_reference, (x, idx),
             "Pallas axis-1 dyn_gather [8,128]", iters or ITERS_AXIS1),
            ("gather_axis0", axis0_gather, axis0_gather_reference,
             (x0, idx0), "Pallas axis-0 dyn_gather [64,128]",
             iters or ITERS_AXIS0)):
        n = args[0].numel()
        out[name] = probes.Launch(
            label, lambda fn=fn, args=args, k=steps: fn(*args, k),
            lambda ref=ref, args=args, k=steps: ref(*args, k), steps,
            {k: v * n * steps for k, v in STEP_OPS.items()}, 12 * n, 1)
    return out


def xla_gather(table, idx):
    """`xla_gather_probe`'s g: the row sums of table[idx]."""
    return table[idx].sum(dim=-1)


def chase(table, idx, steps=CHASE_STEPS):
    """`xla_gather_probe`'s chase: `steps` chained gathers, idx = (table[
    idx][:, 0] + i) % N."""
    n = table.shape[0]
    for i in range(steps):
        idx = torch.remainder(table[idx][:, 0] + i, n)
    return idx


def _event_ms(fn, args, iters):
    """Mean device ms of `iters` calls after a warm-up, from CUDA events
    around the whole run (the TPU probe's timeit, on the card's clock)."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def xla_gather_probe(device, rows=GATHER_ROWS, tables=GATHER_TABLES,
                     chase_table=CHASE_TABLE, iters=10):
    """The TPU probe's torch-gather lines on the card: a list of dicts."""
    g = torch.Generator(device=device).manual_seed(0)
    out = []
    for n in tables[0]:
        for w in tables[1]:
            table = torch.randn((n, w), generator=g, device=device)
            idx = torch.randint(0, n, (rows,), generator=g, device=device,
                                dtype=torch.int32)
            ms = _event_ms(xla_gather, (table, idx), iters)
            gbs = rows * w * 4 / (ms * 1e-3) / 1e9
            mgs = rows / (ms * 1e-3) / 1e6
            print(f"torch gather [{n:>8}x{w:>2}] x {rows} idx: {ms:7.3f} ms "
                  f"{gbs:7.1f} GB/s  {mgs:8.1f} Mgather/s", flush=True)
            out.append({"n": n, "w": w, "ms": ms, "gb_s": gbs,
                        "mgather_s": mgs})
    n, w = chase_table
    table = torch.randint(0, n, (n, w), generator=g, device=device,
                          dtype=torch.int32)
    idx0 = torch.randint(0, n, (rows,), generator=g, device=device,
                         dtype=torch.int32)
    ms = _event_ms(chase, (table, idx0), 3)
    per = ms / CHASE_STEPS
    print(f"torch chained gather {CHASE_STEPS} steps [{n}x{w}]: {ms:.3f} ms "
          f"({per:.3f} ms/step, {rows / (per * 1e-3) / 1e6:.1f} "
          "Mgather/s/step)", flush=True)
    out.append({"chase": CHASE_STEPS, "n": n, "w": w, "ms": ms,
                "ms_per_step": per})
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch_rows = xla_gather_probe(dev)
    a = [torch.as_tensor(t, device=dev)
         for t in inputs(np.random.default_rng(0))]
    lns = launches(*a)
    cycles, ends = probe_crossbar.op_cycles(a[0])
    if not torch.equal(ends.cpu(), probe_crossbar.op_chain_reference(
            a[0].cpu())):
        sys.exit("the bare chain differs from its plain version")
    timed = probes.time_launches(lns, TIMED_LAUNCHES, cycles)
    for name, m in timed.items():
        lookups = lns[name].ops["lds"] / lns[name].steps
        m["glane_lookups_per_s"] = lookups / m["ns_per_step"]
    probes.print_launches("probe_gather", lns, timed, card,
                          torch_gathers=torch_rows)


if __name__ == "__main__":
    main()

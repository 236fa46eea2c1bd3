"""P8: dynamic lane and row access to a component-major [8, N] table.

Counterpart of `scripts/attic/probe_pallas2.py`, whose four kernels asked
how Mosaic reads node i of an [8, N] table (TABLE = arange(8 * 512), IDX =
200), the index held in SMEM:

  - `dyn_lane_slice(idx, t)` (`probe_dyn_lane_slice` :18, pallas_call
    :24): out [8, 128], out[r, :] = t[r, i];
  - `dyn_roll(idx, t)` (`probe_dyn_roll` :36, :43): out [8, 128], the
    aligned block t[:, b : b + 128], b = (i // 128) * 128, rolled left by
    i % 128: out[r, c] = t[r, b + (c + i % 128) % 128];
  - `scalar_dyn_lane(idx, t)` (`probe_scalar_dyn_lane` :55, :61): out [1,
    128] = t[3, i] in every lane;
  - `dyn_sublane_row(idx, packed)` (`probe_dyn_sublane_row` :73, :85): t
    packed row-major, 16 nodes of 8 components a row (`pack_nodes`: t.T
    reshaped to [N // 16, 128]), then out [1, 128] = row i // 16 rolled
    left by (i % 16) * 8, so out[0, :8] = t[:, i].

i = idx[0] is read on the device; an index out of range is taken as JAX
takes it (negative from the end, then clamped: `probes.dyn_start`).  t is
float32 [8, N] (N >= 128 for `dyn_roll`, a multiple of 16 for
`pack_nodes`, which the caller runs before `dyn_sublane_row` as the TPU
probe packs before its pallas_call).  CUDA tensors launch
csrc/probes/features.cu; CPU tensors run the `*_reference` functions.

    python -m dpt_tpu_torch.probes.probe_pallas2

runs the TPU probe's four checks on the card, times each kernel, and
prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import sys

import torch

from dpt_tpu_torch import probes

N = 512
IDX = 200
LANES = 128
ROWS = 8
NODES_PER_ROW = LANES // ROWS  # 16
TIMED_LAUNCHES = 50


def table(device):
    """The TPU probe's TABLE: arange(8 * 512) as float32 [8, 512]."""
    return torch.arange(ROWS * N, dtype=torch.float32,
                        device=device).reshape(ROWS, N)


def pack_nodes(t):
    """[N // 16, 128]: node j's 8 components at row j // 16, lanes (j %
    16) * 8 .. + 8 (the TPU probe's `packed`)."""
    return t.t().reshape(t.shape[1] // NODES_PER_ROW, LANES)


def _i(idx):
    return idx[:1]


def dyn_lane_slice_reference(idx, t):
    col = probes.dyn_start(_i(idx), t.shape[1]).long()
    return t.index_select(1, col).expand(ROWS, LANES).contiguous()


def dyn_roll_reference(idx, t):
    i = _i(idx)
    base = probes.dyn_start(torch.div(i, LANES, rounding_mode="floor")
                            * LANES, t.shape[1], LANES)
    lanes = torch.arange(LANES, dtype=i.dtype, device=t.device)
    cols = base + torch.remainder(lanes + torch.remainder(i, LANES), LANES)
    return t.index_select(1, cols.long())


def scalar_dyn_lane_reference(idx, t):
    col = probes.dyn_start(_i(idx), t.shape[1]).long()
    return t[3].index_select(0, col).reshape(1, 1).expand(1, LANES) \
        .contiguous()


def dyn_sublane_row_reference(idx, packed):
    i = _i(idx)
    row = probes.dyn_start(torch.div(i, NODES_PER_ROW, rounding_mode="floor"),
                           packed.shape[0]).long()
    shift = torch.remainder(i, NODES_PER_ROW) * ROWS
    lanes = torch.arange(LANES, dtype=i.dtype, device=packed.device)
    cols = torch.remainder(lanes + shift, LANES).long()
    return packed.index_select(0, row).index_select(1, cols)


def _columns(t, least=1):
    """t's column count, after checking t is float32 [8, >= least]."""
    probes.check_tensor("t", t, torch.float32, (ROWS, None))
    if t.shape[1] < least:
        raise ValueError(f"t needs >= {least} columns, got {t.shape[1]}")
    return t.shape[1]


def _run(name, reference, idx, t, out_rows, dim):
    """The kernel `name` over t (whose axis the index runs along has `dim`
    entries) on a CUDA tensor, `reference` on a CPU one."""
    probes.check_tensor("idx", idx, torch.int32, (None,))
    if idx.numel() < 1:
        raise ValueError("idx must not be empty")
    if probes.on_device(idx, t) == "cpu":
        return reference(idx, t)
    out = torch.empty((out_rows, LANES), dtype=torch.float32,
                      device=t.device)
    return probes.launch_kernel(name, out, idx.contiguous(), t.contiguous(),
                                dim)


def dyn_lane_slice(idx, t):
    """[8, 128] f32: column i of t in every lane."""
    return _run("dyn_lane_slice", dyn_lane_slice_reference, idx, t, ROWS,
                _columns(t))


def dyn_roll(idx, t):
    """[8, 128] f32: the aligned block of column i, rolled so that column
    i is lane 0."""
    return _run("dyn_roll", dyn_roll_reference, idx, t, ROWS,
                _columns(t, LANES))


def scalar_dyn_lane(idx, t):
    """[1, 128] f32: t[3, i] in every lane."""
    return _run("scalar_dyn_lane", scalar_dyn_lane_reference, idx, t, 1,
                _columns(t))


def dyn_sublane_row(idx, packed):
    """[1, 128] f32: the row of node i in `packed` ([N // 16, 128], from
    `pack_nodes`), rolled so that its 8 components are lanes 0-7."""
    probes.check_tensor("packed", packed, torch.float32, (None, LANES))
    if packed.shape[0] < 1:
        raise ValueError("packed must not be empty")
    return _run("dyn_sublane_row", dyn_sublane_row_reference, idx, packed,
                1, packed.shape[0])


def probe_lines(device, i=IDX):
    """The TPU probe's four checks through the wrappers on `device` at its
    TABLE and index i: [(label, ok)]."""
    t = table(device)
    idx = torch.tensor([i], dtype=torch.int32).to(device)
    return [
        ("dyn lane slice",
         bool(torch.equal(dyn_lane_slice(idx, t)[:, 0], t[:, i]))),
        ("dyn roll", bool(torch.equal(dyn_roll(idx, t)[:, 0], t[:, i]))),
        ("scalar dyn lane",
         bool(torch.equal(scalar_dyn_lane(idx, t)[0, 0], t[3, i]))),
        ("dyn sublane row + roll",
         bool(torch.equal(dyn_sublane_row(idx, pack_nodes(t))[0, :ROWS],
                          t[:, i]))),
    ]


def launches(device):
    """kernel -> `probes.Launch` at the TPU probe's TABLE and IDX: the
    index and the words read, the output written."""
    t = table(device)
    packed = pack_nodes(t)
    idx = torch.tensor([IDX], dtype=torch.int32).to(device)
    tile = 4 * ROWS * LANES
    return {
        "dyn_lane_slice": probes.Launch(
            "dyn lane slice", lambda: dyn_lane_slice(idx, t),
            lambda: dyn_lane_slice_reference(idx, t), 1, {},
            4 + 4 * ROWS + tile),
        "dyn_roll": probes.Launch(
            "dyn roll", lambda: dyn_roll(idx, t),
            lambda: dyn_roll_reference(idx, t), 1, {}, 4 + 2 * tile),
        "scalar_dyn_lane": probes.Launch(
            "scalar dyn lane", lambda: scalar_dyn_lane(idx, t),
            lambda: scalar_dyn_lane_reference(idx, t), 1, {}, 8 + 4 * LANES),
        "dyn_sublane_row": probes.Launch(
            "dyn sublane row + roll", lambda: dyn_sublane_row(idx, packed),
            lambda: dyn_sublane_row_reference(idx, packed), 1, {},
            4 + 8 * LANES),
    }


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for label, ok in probe_lines(dev):
        print(f"{label}: {ok}", flush=True)
        if not ok:
            sys.exit(f"{label} failed")
    lns = launches(dev)
    probes.print_launches("probe_pallas2", lns,
                          probes.time_launches(lns, TIMED_LAUNCHES), card)


if __name__ == "__main__":
    main()

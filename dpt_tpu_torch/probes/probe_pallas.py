"""P7: the Mosaic feature checks of a packet-BVH kernel's primitives.

Counterpart of `scripts/attic/probe_pallas.py`, whose four kernels asked
whether Mosaic lowers a dynamic row load from VMEM with the index in SMEM,
a scalar extract, an SMEM stack in a while loop and integer vector ops:

  - `scalar_load_from_vmem(idx, table)` (`probe_scalar_load_from_vmem`
    :17, pallas_call :27): out [1, 128] = table[idx[0], :] * 2;
  - `scalar_extract(idx, table)` (`probe_scalar_extract` :40, :51): out [1,
    128] = table[idx[0], 0] in every lane;
  - `smem_stack_while(device)` (`probe_smem_stack_while` :63, :94): a stack
    [7, 3] of int32 popped while sp > 0, a 3 replaced by 1 on the way; out
    [1, 128] = 3 + 1 + 7 = 11.0 in every lane;
  - `int_vector_ops(device)` (`probe_int_vector_ops` :104, :110): out [8,
    128] int32 = c if the lane c is even, else -c.

idx is an int32 tensor whose first element is read on the device (the TPU
probe holds it in SMEM); table is float32 [N, 128] (the TPU probe's is [8,
128]).  An index out of range is taken as JAX takes it (negative from the
end, then clamped: `probes.dyn_start`).  CUDA tensors launch
csrc/probes/features.cu; CPU tensors run the `*_reference` functions.

    python -m dpt_tpu_torch.probes.probe_pallas

runs the TPU probe's four checks on the card, times each kernel, and
prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import sys

import torch

from dpt_tpu_torch import probes

LANES = 128
TIMED_LAUNCHES = 50


def _check_row_table(idx, table):
    probes.check_tensor("idx", idx, torch.int32, (None,))
    probes.check_tensor("table", table, torch.float32, (None, LANES))
    if idx.numel() < 1 or table.shape[0] < 1:
        raise ValueError("idx and table must not be empty")
    return probes.on_device(idx, table)


def _row(idx, n_rows):
    """The row the kernels read: dyn_start(idx[0], n_rows), as a [1] index
    tensor on idx's device (no host sync)."""
    return probes.dyn_start(idx[:1], n_rows).long()


def scalar_load_from_vmem_reference(idx, table):
    return table.index_select(0, _row(idx, table.shape[0])) * 2.0


def scalar_extract_reference(idx, table):
    v = table[:, 0].index_select(0, _row(idx, table.shape[0]))
    return v.reshape(1, 1).expand(1, LANES).contiguous()


def smem_stack_while_reference(device):
    stack = [0] * 32
    stack[0], stack[1] = 7, 3
    sp = 2
    acc = torch.zeros((1, LANES), dtype=torch.float32, device=device)
    while sp > 0:
        top = stack[sp - 1]
        acc = acc + float(top)
        if top == 3:
            stack[sp - 1] = 1
        else:
            sp -= 1
    return acc


def int_vector_ops_reference(device):
    i = torch.arange(LANES, dtype=torch.int32, device=device).expand(8, LANES)
    return torch.where(i % 2 == 0, i, -i).contiguous()


def _out(shape, device, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device)


def scalar_load_from_vmem(idx, table):
    """[1, 128] f32: table[idx[0], :] * 2."""
    if _check_row_table(idx, table) == "cpu":
        return scalar_load_from_vmem_reference(idx, table)
    return probes.launch_kernel(
        "scalar_load", _out((1, LANES), table.device), idx.contiguous(),
        table.contiguous(), table.shape[0])


def scalar_extract(idx, table):
    """[1, 128] f32: table[idx[0], 0] in every lane."""
    if _check_row_table(idx, table) == "cpu":
        return scalar_extract_reference(idx, table)
    return probes.launch_kernel(
        "scalar_extract", _out((1, LANES), table.device), idx.contiguous(),
        table.contiguous(), table.shape[0])


def smem_stack_while(device):
    """[1, 128] f32: the stack walk's sum, 11.0."""
    device = torch.device(device)
    if device.type == "cpu":
        return smem_stack_while_reference(device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return probes.launch_kernel("smem_stack", _out((1, LANES), device))


def int_vector_ops(device):
    """[8, 128] int32: c where the lane c is even, else -c."""
    device = torch.device(device)
    if device.type == "cpu":
        return int_vector_ops_reference(device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return probes.launch_kernel("int_vector_ops",
                                _out((8, LANES), device, torch.int32))


def table(device):
    """The TPU probe's table: arange(8 * 128) as float32 [8, 128]."""
    return torch.arange(8 * LANES, dtype=torch.float32,
                        device=device).reshape(8, LANES)


def probe_lines(device):
    """The TPU probe's four checks, run through the wrappers on `device`:
    [(label, ok, printed values)]."""
    t = table(device)
    i3 = torch.tensor([3], dtype=torch.int32).to(device)
    i5 = torch.tensor([5], dtype=torch.int32).to(device)
    row = scalar_load_from_vmem(i3, t)
    ext = scalar_extract(i5, t)
    stack = smem_stack_while(device)
    ints = int_vector_ops(device)
    return [
        ("dyn row load", bool(torch.equal(row[0], t[3] * 2)), ""),
        ("dyn scalar extract", bool((ext[0] == t[5, 0]).all()), ""),
        ("smem stack while", float(stack[0, 0]) == 11.0,
         f"{float(stack[0, 0])} (expect 11.0)"),
        ("int vector ops", (int(ints[0, 2]), int(ints[0, 3])) == (2, -3),
         f"{int(ints[0, 2])} {int(ints[0, 3])} (expect 2 -3)"),
    ]


def launches(device):
    """kernel -> `probes.Launch` at the TPU probe's inputs (its arange
    table, idx 3): the index and the words read, the output written."""
    t = table(device)
    idx = torch.tensor([3], dtype=torch.int32).to(device)
    lanes = 4 * LANES
    return {
        "scalar_load": probes.Launch(
            "dyn row load", lambda: scalar_load_from_vmem(idx, t),
            lambda: scalar_load_from_vmem_reference(idx, t), 1,
            {"f32": LANES}, 4 + 2 * lanes),
        "scalar_extract": probes.Launch(
            "dyn scalar extract", lambda: scalar_extract(idx, t),
            lambda: scalar_extract_reference(idx, t), 1, {}, 8 + lanes),
        "smem_stack": probes.Launch(
            "smem stack while", lambda: smem_stack_while(device),
            lambda: smem_stack_while_reference(device), 1, {}, lanes),
        "int_vector_ops": probes.Launch(
            "int vector ops", lambda: int_vector_ops(device),
            lambda: int_vector_ops_reference(device), 1, {}, 8 * lanes),
    }


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for label, ok, extra in probe_lines(dev):
        print(f"{label}: {extra or ok}", flush=True)
        if not ok:
            sys.exit(f"{label} failed")
    lns = launches(dev)
    probes.print_launches("probe_pallas", lns,
                          probes.time_launches(lns, TIMED_LAUNCHES), card)


if __name__ == "__main__":
    main()

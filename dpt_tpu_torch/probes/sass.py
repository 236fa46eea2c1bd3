"""The step loops of a built probe library's kernels in the machine code
(`cuobjdump -sass`), for the scripts that count a step's instructions
(scripts/torch_interleave_shapes.py, scripts/torch_interleave2_shapes.py,
scripts/torch_crossbar_shapes.py, and P1's leaf loop in `python -m
dpt_tpu_torch.probes.r3_smem_proto --sass`).

A kernel's step loop is its backward branch that spans the most loads of
one kind: global loads (LDG) for the walks, each step of which loads its
record (and leaf row) while the loops around it (set-up, the exit's merge)
load less or nothing; shared loads (LDS) for P4's lookups, whose
tables are filled before the loop by stores alone; float adds (FADD) for
P4-d, whose loop over chunks of row addresses holds its step loop, with
more shared loads but no more adds (of two loops over as many, the one
whose branch comes first, the inner, stays).  A leaf loop is the
innermost such loop.
"""

from __future__ import annotations

import collections
import pathlib
import re
import subprocess


def dump(lib_path) -> str:
    """`cuobjdump -sass` of a built library (cuobjdump beside nvcc)."""
    from dpt_tpu_torch.kernels import build

    cuobjdump = pathlib.Path(build.find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout


def opcode(text: str) -> str:
    """The opcode of an instruction's text, past a predicate (@P0)."""
    return text.split()[1 if text.startswith("@") else 0]


def step_loops(text: str, kernel: str, innermost=False, loads=("LDG",)):
    """[(match, opcodes)] for each function of the listing `text` whose
    name matches the regex `kernel` (the match of its first line) and that
    has a backward branch over a load whose opcode starts with one of
    `loads` (global loads by default, ("LDS",) for shared ones): the
    opcodes of its step loop, from the branch's target to the branch, in
    order.  With `innermost`,
    only loops that hold no other backward branch count, and of two with as
    many loads the shorter wins: a walk's leaf loop (P1's leaf rows, whose
    redo with the IEEE reciprocal is a second, longer loop over the same
    loads) rather than the walk loop around it."""
    out = []
    for block in text.split("Function : ")[1:]:
        m = re.search(kernel, block.splitlines()[0])
        if m is None:
            continue
        instrs, labels = [], {}
        for line in block.splitlines()[1:]:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(instrs)
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if ins:
                instrs.append((int(ins.group(1), 16), ins.group(2).strip()))
        addr_index = {a: k for k, (a, _) in enumerate(instrs)}
        loops = []
        for k, (_, text_k) in enumerate(instrs):
            if opcode(text_k) != "BRA":
                continue
            tgt = re.search(r"`\((\.L_x_\d+)\)|BRA\s+(0x[0-9a-f]+)", text_k)
            if tgt is None:
                continue
            j = (labels.get(tgt.group(1)) if tgt.group(1)
                 else addr_index.get(int(tgt.group(2), 16)))
            if j is not None and j <= k:
                loops.append((j, k))
        if innermost:
            loops = [(j, k) for j, k in loops
                     if not any(j <= a and b < k for a, b in loops)]
        best, best_loads = None, 0
        for j, k in loops:
            n = sum(opcode(t).startswith(tuple(loads))
                    for _, t in instrs[j:k + 1])
            if n > best_loads or (innermost and best is not None and n ==
                                  best_loads and k - j < best[1] - best[0]):
                best, best_loads = (j, k), n
        if best is not None:
            out.append((m, [opcode(t) for _, t in
                            instrs[best[0]:best[1] + 1]]))
    return out


def loop_counts(text: str, kernel: str, adds: int = 1,
                loads=("LDS",)) -> list:
    """[(match, counts)] of each function of `text` matching `kernel` (as
    `step_loops`, by `loads`): its step loop's instructions, its steps
    (the FADD in it over `adds`, each step's dependent adds),
    instructions, shared loads (LDS) and global loads (LDG, not LDGSTS) a
    step, and each of its opcodes a step, the commonest first."""
    out = []
    for m, ops in step_loops(text, kernel, loads=loads):
        count = collections.Counter(o.split(".")[0] for o in ops)
        steps = count["FADD"] / adds
        if steps == 0:
            continue
        out.append((m, {
            "loop_instructions": len(ops), "steps": steps,
            "per_step": len(ops) / steps,
            "lds_per_step": count["LDS"] / steps,
            "ldg_per_step": count["LDG"] / steps,
            "by_opcode": {o: c / steps for o, c in count.most_common()},
        }))
    return out

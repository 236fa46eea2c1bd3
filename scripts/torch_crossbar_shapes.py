"""P4-b and P4-c (csrc/probes/crossbar.cu `lanes_kernel`, `fused_kernel`)
in the grid they are built for, beside the one-block kernels of an older
tree: what a lane lookup from a table copied once a shared-memory bank
costs, and whether the indices change it.

    python scripts/torch_crossbar_shapes.py [--old DIR] [--sass]

Each build's P4-b (K = 1, 4, 12 at the TPU script's 2,000 // K steps) and
P4-c (2,000 steps), on each index pattern of
`probe_crossbar.index_patterns` (seeded, one bank, identity), is first
checked equal to its plain version bit for bit, then timed with
`probes.launch_ms` (the median of 20 launches behind a sleep) in turns over
3 rounds, the order reversed every round.  This tree's kernels run
through the public wrappers (`lane_gathers`, `fused_lookup`).

  --old DIR           DIR/crossbar.cu of an older tree, with its
                      probe_common.cuh and ../traverse_common.cuh (the C
                      interface `dpt_probe_crossbar_lanes(x, idx, K, iters,
                      out, stream)` and `dpt_probe_crossbar_fused(x, lane,
                      srow, iters, out, stream)`), e.g. the one-block
                      kernels unpacked by `git archive <commit>
                      dpt_tpu_torch/csrc | tar -x -C
                      dpt_tpu_torch/_build/old`; built alone by
                      `kernels/build.build` (the probe library's flags) and
                      timed as "old" in the same turns.
  --sass              each build's step loops in the machine code
                      (`cuobjdump -sass`): of each kernel, the loop over the
                      most shared loads (LDS), its steps (its FADD over K),
                      and its instructions and LDS a step.

Prints the card's name and power limit, one line per kernel and pattern
(the median of the rounds' medians, ns a step, the old build's time over
this tree's), each build's time at 0 steps on the seeded tile
(the fill of its copies and the launch alone) and its loop's ns a step
(the seeded time less that), each build's one-bank and identity times over
its seeded time, each kernel's latency bound (its steps x K dependent adds at
the card's clocks a dependent operation, `probe_crossbar.op_cycles`), and
one JSON line.  Needs a CUDA card.
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

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dpt_tpu_torch import probes  # noqa: E402
from dpt_tpu_torch.kernels import build  # noqa: E402
from dpt_tpu_torch.probes import probe_crossbar as p4  # noqa: E402
from dpt_tpu_torch.probes import sass  # noqa: E402

KERNELS = (*(f"lanes_K{K}" for K in p4.KS), "fused")
TIMED_LAUNCHES = 20
ROUNDS = 3


def sources(probe_dir: pathlib.Path):
    return [probe_dir / "crossbar.cu", probe_dir / "probe_common.cuh",
            probe_dir.parent / "traverse_common.cuh"]


def steps_of(kernel):
    """(steps, dependent adds a step) of a kernel at the TPU script's
    ITERS."""
    if kernel == "fused":
        return p4.ITERS, 1
    K = int(kernel.split("_K")[1])
    return p4.ITERS // K, K


def library_caller(lib_path):
    """call(kernel, x, tiles) -> out through the C interface of a crossbar.cu
    built alone at `lib_path`."""
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dpt_probe_crossbar_lanes.argtypes = [p, p, i, i, p, p]
    lib.dpt_probe_crossbar_fused.argtypes = [p, p, p, i, p, p]
    lib.dpt_probe_crossbar_lanes.restype = i
    lib.dpt_probe_crossbar_fused.restype = i

    def call(kernel, x, t, steps=None):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        K = steps_of(kernel)[1]
        steps = steps_of(kernel)[0] if steps is None else steps
        if kernel == "fused":
            err = lib.dpt_probe_crossbar_fused(
                x.data_ptr(), t["lane"].data_ptr(), t["srow"].data_ptr(),
                steps, out.data_ptr(), stream)
        else:
            err = lib.dpt_probe_crossbar_lanes(
                x.data_ptr(), t["idx"].data_ptr(), K, steps, out.data_ptr(),
                stream)
        if err:
            raise RuntimeError(f"{lib_path.name} {kernel}: cudaError {err}")
        return out

    return call


def tree_call(kernel, x, t, steps=None):
    steps_, K = steps_of(kernel)
    steps = steps_ if steps is None else steps
    if kernel == "fused":
        return p4.fused_lookup(x, t["lane"], t["srow"], steps)
    return p4.lane_gathers(x, t["idx"], K, steps * K)


def plain(kernel, x, t):
    steps, K = steps_of(kernel)
    if kernel == "fused":
        return p4.fused_lookup_reference(x, t["lane"], t["srow"], steps)
    return p4.lane_gathers_reference(x, t["idx"], K, steps)


def step_loops(lib_path):
    """{kernel: {...}} of a built library: each kernel's loop over the most
    shared loads, its steps (FADD over K), instructions and LDS a step."""
    text = sass.dump(lib_path)
    out = {}
    for regex in (r"lanes_kernelILi(\d+)E", r"(fused)_kernel"):
        for m, ops in sass.step_loops(text, regex, loads=("LDS",)):
            kernel = ("fused" if m.group(1) == "fused"
                      else f"lanes_K{m.group(1)}")
            count = collections.Counter(o.split(".")[0] for o in ops)
            steps = count["FADD"] / steps_of(kernel)[1]
            out[kernel] = {
                "loop_instructions": len(ops), "steps": steps,
                "per_step": len(ops) / steps, "lds_per_step":
                    count["LDS"] / steps,
                "by_opcode": {o: c / steps for o, c in count.most_common(10)},
            }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path, default=None)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    paths = {"tree": build.library_path("libdpt_probes",
                                        build._probe_sources())}
    calls = {"tree": tree_call}
    if args.old is not None:
        paths["old"] = build.build("libdpt_crossbar_old", sources(args.old))
        calls["old"] = library_caller(paths["old"])
    builds = list(calls)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(p4.ROWS, p4.LANES))
                        .astype(np.float32), device=dev)
    tiles = {name: {k: torch.as_tensor(v, device=dev) for k, v in t.items()}
             for name, t in p4.index_patterns(rng).items()}
    # (build, kernel, pattern); "none" is the seeded tile at 0 steps: the
    # fill and the launch alone
    configs = [(b, k, pat) for k in KERNELS for pat in (*p4.PATTERNS, "none")
               for b in builds]
    tiles["none"] = tiles["seeded"]

    def run(b, k, pat):
        return calls[b](k, x, tiles[pat], 0 if pat == "none" else None)

    refs = {}
    for b, k, pat in configs:
        if pat == "none":
            continue
        if (k, pat) not in refs:
            refs[k, pat] = plain(k, x, tiles[pat])
        got = run(b, k, pat)
        torch.cuda.synchronize()
        if not torch.equal(got, refs[k, pat]):
            raise AssertionError(f"{b} {k} {pat} differs from its plain "
                                 "version")
    print(f"exact: {len(configs)} launches (builds {builds}) equal their "
          "plain versions", flush=True)
    cycles, ends = p4.op_cycles(x)
    if not torch.equal(ends.cpu(), p4.op_chain_reference(x.cpu())):
        raise AssertionError("the bare chain differs from its plain version")

    rounds = {c: [] for c in configs}
    for r in range(ROUNDS):
        for c in (configs if r % 2 == 0 else configs[::-1]):
            b, k, pat = c
            rounds[c].append(statistics.median(probes.launch_ms(
                lambda b=b, k=k, pat=pat: run(b, k, pat), [()],
                n=TIMED_LAUNCHES)))
    ms = {c: statistics.median(v) for c, v in rounds.items()}

    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "rounds": ROUNDS, "cycles_per_op": cycles, "ms": {},
              "rounds_ms": {}, "pattern_ratio": {}, "latency_bound_ms": {},
              "loop_ns_per_step": {}}
    for k in KERNELS:
        steps, chain = steps_of(k)
        bound = probes.latency_bound_ms(steps, chain, cycles)
        result["latency_bound_ms"][k] = bound
        for pat in p4.PATTERNS:
            tree = ms["tree", k, pat]
            line = ", ".join(
                f"{b} {ms[b, k, pat]:.4f} ({ms[b, k, pat] / tree:.2f}x)"
                for b in builds[1:])
            print(f"[time] {k} {pat}: tree {tree:.4f} ms "
                  f"({tree * 1e6 / steps:.1f} ns a step; rounds "
                  f"{min(rounds['tree', k, pat]):.4f}-"
                  f"{max(rounds['tree', k, pat]):.4f})"
                  + (f"; {line}" if line else ""), flush=True)
        for pat in (*p4.PATTERNS, "none"):
            for b in builds:
                result["ms"][f"{b} {k} {pat}"] = ms[b, k, pat]
                result["rounds_ms"][f"{b} {k} {pat}"] = rounds[b, k, pat]
        loop = {b: (ms[b, k, "seeded"] - ms[b, k, "none"]) * 1e6 / steps
                for b in builds}
        result["loop_ns_per_step"][k] = loop
        print(f"[fixed] {k} at 0 steps (the fill and the launch): "
              + ", ".join(f"{b} {ms[b, k, 'none']:.4f} ms" for b in builds)
              + "; the loop, seeded less that, ns a step: "
              + ", ".join(f"{b} {v:.2f}" for b, v in loop.items()),
              flush=True)
        for b in builds:
            seeded = ms[b, k, "seeded"]
            ratios = {pat: ms[b, k, pat] / seeded for pat in p4.PATTERNS[1:]}
            result["pattern_ratio"][f"{b} {k}"] = ratios
            print(f"[pattern] {b} {k}: " + ", ".join(
                f"{pat} / seeded {v:.3f}" for pat, v in ratios.items()),
                flush=True)
        print(f"[bound] {k}: {steps} steps x {chain} dependent adds at the "
              f"card's {cycles:.4f} clocks an operation: {bound:.5f} ms, "
              f"{100 * bound / ms['tree', k, 'seeded']:.3g}% of the tree's "
              "seeded time", flush=True)
    if args.sass:
        result["sass"] = {}
        for b in builds:
            loops = step_loops(paths[b])
            if sorted(loops) != sorted(KERNELS):
                sys.exit(f"{b}: found the step loops of {sorted(loops)} in "
                         "the machine code, not of every kernel")
            result["sass"][b] = loops
            for k, c in loops.items():
                print(f"[sass] {b} {k}: {c['per_step']:.2f} instructions a "
                      f"step, {c['lds_per_step']:.2f} LDS a step "
                      f"({c['loop_instructions']} in a loop of "
                      f"{c['steps']:g} steps); " + ", ".join(
                          f"{o} {n:.2f}" for o, n in c["by_opcode"].items()),
                      flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

"""P2 (csrc/probes/interleave2.cu) in the shape it is built for, beside the
one-block kernel of an older tree: what the stack and the leaf tests add to
a walk step, and how the cluster design compares with the first port.

    python scripts/torch_interleave2_shapes.py [--old DIR] [--sass]

Runs `probe_interleave2.survey` (A-D at P = 1 and 8, and P6 at the same P,
512 steps, each kernel checked equal to its plain version bit for bit,
then timed with `probes.launch_ms` in turns over 3 rounds of 20 launches,
the order reversed every round).

  --old DIR   DIR/interleave2.cu of an older tree, with its
              probe_common.cuh and ../traverse_common.cuh (one block of
              1024 threads, the C interface (nodes, tris, rays, P, variant,
              iters, out, sink, stream)), e.g. unpacked by `git archive
              <commit> dpt_tpu_torch/csrc | tar -x -C
              dpt_tpu_torch/_build/old`; built alone by `kernels/build.build`
              (the probe library's flags) and timed as "old T=1024" in the
              same turns.
  --sass      the step loop of each variant and P in the machine code
              (`cuobjdump -sass` of this tree's interleave2.cu): its
              instructions a chain-step (the loop's over P), by opcode, and
              its reciprocals (MUFU.RCP), calls and branches, which split
              the loop into blocks the compiler schedules apart.

Prints the card's name and power limit, one line per kernel, variant and
P, the summary (B - A, C - B, D - B for each build, A - P6, the latency
floor), and one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dpt_tpu_torch.kernels import build  # noqa: E402
from dpt_tpu_torch.probes import probe_interleave2 as p2  # noqa: E402
from dpt_tpu_torch.probes import sass  # noqa: E402


def sources(probe_dir: pathlib.Path):
    return [probe_dir / "interleave2.cu", probe_dir / "probe_common.cuh",
            probe_dir.parent / "traverse_common.cuh"]


def old_launcher(lib_path):
    """launch(nodes, tris, rays, variant, iters) -> (acc, sink) of the
    one-block kernel of an older tree's interleave2.cu, built at
    `lib_path`."""
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.dpt_probe_interleave2
    fn.argtypes = [p, p, p, i, i, i, p, p, p]
    fn.restype = i

    def run(nodes, tris, rays, variant, iters):
        P = rays.shape[0]
        out = torch.empty((P, p2.TILE), dtype=torch.float32,
                          device=rays.device)
        sink = torch.empty((P, 3), dtype=torch.int32, device=rays.device)
        err = fn(nodes.data_ptr(), tris.data_ptr(), rays.data_ptr(), P,
                 p2.VARIANTS.index(variant), iters, out.data_ptr(),
                 sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old interleave2 launch: cudaError {err}")
        return out, sink

    return run


def step_loops(lib_path):
    """{"V P": {...}} for each kernel (template <P, V>) of the library's
    interleave2.cu, from `cuobjdump -sass` (`probes.sass.step_loops`: the
    loop spanning the most record and leaf-row loads, one step of all P
    chains)."""
    out = {}
    for m, ops in sass.step_loops(sass.dump(lib_path),
                                  r"interleave2_kernelILi(\d+)ELi(\d+)E"):
        P, V = (int(g) for g in m.groups())
        count = collections.Counter(o.split(".")[0] for o in ops)
        out[f"{p2.VARIANTS[V]} P={P}"] = {
            "loop_instructions": len(ops),
            "per_chain_step": len(ops) / P,
            "rcp": sum(o.startswith("MUFU.RCP") for o in ops),
            "calls": count["CALL"], "branches": count["BRA"],
            "convergence": count["BSSY"] + count["BSYNC"],
            "by_opcode": {o: c / P for o, c in count.most_common(12)},
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path, default=None)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    others = []
    if args.old is not None:
        old_path = build.build("libdpt_interleave2_old", sources(args.old))
        # one block of 1024 threads on one SM: 32 warps
        others.append(("old T=1024", old_launcher(old_path), 32))
    result = p2.survey(others)
    if args.sass:
        loops = step_loops(build.build("libdpt_interleave2",
                                       sources(build.PROBE_CSRC)))
        if len(loops) != len(p2.VARIANTS) * len(p2.PS):
            sys.exit(f"found the step loops of {sorted(loops)} in the "
                     "machine code, not of every variant and P")
        for name, c in loops.items():
            print(f"[sass] {name}: {c['per_chain_step']:.1f} instructions a "
                  f"chain-step ({c['loop_instructions']} in the loop), "
                  f"{c['rcp']} MUFU.RCP, {c['calls']} CALL, "
                  f"{c['branches']} BRA, {c['convergence']} BSSY/BSYNC; "
                  + ", ".join(f"{o} {n:.1f}" for o, n in
                              c["by_opcode"].items()), flush=True)
        print(json.dumps({"sass": loops, "summary": result["summary"]}))


if __name__ == "__main__":
    main()

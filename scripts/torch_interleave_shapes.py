"""P5 and P6 (csrc/probes/interleave.cu) in the shape each is built for,
beside the one-block kernel of an older tree: how the shapes were chosen,
and what the chains wait on.

    python scripts/torch_interleave_shapes.py [--old DIR] [--sass]
        [--iters 512] [--rounds 2]

Runs `probe_interleave.survey` (every P in PS, each kernel checked equal
to the plain version bit for bit, then timed with `probes.launch_ms` in
turns over `--rounds` rounds, the order reversed every round).

  --old DIR   DIR/interleave.cu of an older tree, with its probe_common.cuh
              and ../traverse_common.cuh (one block of 1024 threads, the C
              interface (nodes, rays, P, iters, any, out, sink, stream)),
              e.g. unpacked by `git archive <commit> dpt_tpu_torch/csrc |
              tar -x -C dpt_tpu_torch/_build/old`; built alone by
              `kernels/build.build` (the probe library's flags) and timed as
              "old T=1024" for P5 and P6 in the same turns.
  --sass      P5's step loop in the machine code (`cuobjdump -sass` of
              this tree's interleave.cu, and of the older one with --old):
              for each P, the instructions a chain-step (the loop's
              instructions over its F2I, one a chain-step: the trunc of
              the record's pointer), by opcode, and the records whose
              loads (LDG) are issued before the loop's first float
              instruction (four loads a record: three of 16 bytes and
              the pointer's 4; the 12 bytes after it are never read).

Prints the card's name and power limit, one line per kernel and P, the
summary, and one JSON line.  Needs a CUDA card.
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
from dpt_tpu_torch.probes import probe_interleave as p5  # noqa: E402
from dpt_tpu_torch.probes import sass  # noqa: E402


def sources(probe_dir: pathlib.Path):
    return [probe_dir / "interleave.cu", probe_dir / "probe_common.cuh",
            probe_dir.parent / "traverse_common.cuh"]


def old_launcher(lib_path, any_in_index):
    """launch(nodes, rays, iters) -> (acc, sink) of the one-block kernel of
    an older tree's interleave.cu, built at `lib_path`."""
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.dpt_probe_interleave
    fn.argtypes = [p, p, i, i, i, p, p, p]
    fn.restype = i

    def run(nodes, rays, iters):
        P = rays.shape[0]
        out = torch.empty((P, p5.TILE), dtype=torch.float32,
                          device=rays.device)
        sink = torch.empty((P, 3), dtype=torch.int32, device=rays.device)
        err = fn(nodes.data_ptr(), rays.data_ptr(), P, iters,
                 int(any_in_index), out.data_ptr(), sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old interleave launch: cudaError {err}")
        return out, sink

    return run


def step_loops(lib_path):
    """{P: {...}} for each P5 kernel (no any) in the library, from
    `cuobjdump -sass` (`probes.sass.step_loops`); a chain-step is one of
    the step loop's F2I."""
    out = {}
    for m, ops in sass.step_loops(sass.dump(lib_path),
                                  r"interleave_kernelILi(\d+)ELb0E"):
        chain_steps = sum(o.startswith("F2I") for o in ops)
        if not chain_steps:
            continue
        first_float = next((k for k, o in enumerate(ops)
                            if o.startswith(("FADD", "FMUL", "FMNMX",
                                             "FSETP"))), len(ops))
        out[int(m.group(1))] = {
            "loop_instructions": len(ops),
            "chain_steps": chain_steps,
            "per_chain_step": len(ops) / chain_steps,
            "records_before_first_float": sum(
                o.startswith("LDG") for o in ops[:first_float]) / 4,
            "by_opcode": {o: c / chain_steps for o, c in
                          collections.Counter(o.split(".")[0]
                                              for o in ops).most_common()},
        }
    return out


def print_sass(label, loops):
    if not loops:
        print(f"[sass {label}] no P5 step loop found", flush=True)
    for P, c in sorted(loops.items()):
        print(f"[sass {label}] P={P}: {c['per_chain_step']:.1f} instructions "
              f"a chain-step ({c['loop_instructions']} in the loop, "
              f"{c['chain_steps']:g} chain-steps), "
              f"{c['records_before_first_float']:g} records loaded before "
              "the first float instruction; "
              + ", ".join(f"{o} {n:.2f}" for o, n in c["by_opcode"].items()),
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path, default=None)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--iters", type=int, default=p5.ITERS)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    others, found = [], {}
    old_path = None
    if args.old is not None:
        old_path = build.build("libdpt_interleave_old", sources(args.old))
        # one block of 1024 threads on one SM: 32 warps
        others += [("old T=1024", anyi, old_launcher(old_path, anyi), 32)
                   for anyi in (False, True)]
    result = p5.survey(others, iters=args.iters, rounds=args.rounds)
    if args.sass:
        found["new"] = step_loops(build.build(
            "libdpt_interleave", sources(build.PROBE_CSRC)))
        if old_path is not None:
            found["old"] = step_loops(old_path)
        for label, loops in found.items():
            print_sass(label, loops)
        print(json.dumps({"sass": found, "summary": result["summary"]}))


if __name__ == "__main__":
    main()

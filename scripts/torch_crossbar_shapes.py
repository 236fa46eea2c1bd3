"""P4-a, P4-b, P4-c and P4-d (csrc/probes/crossbar.cu `sublane_kernel`,
`lanes_kernel`, `fused_kernel`, `rows_kernel`) and P3-a and P3-b
(`lanes_kernel<1>`, `column_kernel`) in the grids they are built for,
beside an older tree's kernels, A and D in blocks of 128, D loading its
row blocks by plain loads, and P3-b 8 elements a thread: what a lookup
from shared memory and a row block from L2 cost, and whether the indices
change it.

    python scripts/torch_crossbar_shapes.py [--old DIR] [--sass]

Each build's P4-a (2,000 steps; the index pattern's `srow` tile as its
`sub`), P4-b (K = 1, 4, 12 at the TPU script's 2,000 // K steps) and P4-c
(2,000 steps), on each index pattern of `probe_crossbar.index_patterns`
(seeded, one bank, identity), and its P4-d at 2,000 and 2,003 rows of
`probe_crossbar.inputs`' table (seed 0), and its P3-a (1,000 steps, the
pattern's idx tile) and P3-b (100 steps, `probe_gather.row_patterns`) on
a seeded x, is first checked equal to its plain version bit for bit, then
timed with `probes.launch_ms` (the median of 20 launches behind a sleep)
in turns over 3 rounds, the order reversed every round.  This tree's
kernels run through the public wrappers (`sublane_gather`,
`lane_gathers`, `fused_lookup`, `row_blocks`, `axis1_gather`,
`axis0_gather`).  The edited copies of this tree's crossbar.cu
(`EDITS`), each written under `dpt_tpu_torch/_build/crossbar_NAME/` and
built alone: "w128" runs A and D in 8 blocks of 128 threads (a tile row
each; `kSublaneThreads`, `kRowsThreads`), timed for both; "ldg8",
"ldg16" and "ldg32" put in place of D's ring its step loop before the
ring (the row starts staged in shared memory, one plain load a step, 8,
16 or 32 steps' loads in flight) over the same 32 one-warp blocks, timed
for D; "chains8" runs P3-b in 32 blocks of one warp, 8 elements a thread
(rows r, r + 8, ..., r + 56 of one column: 8 independent sums), timed
for P3-b.

  --old DIR           DIR/crossbar.cu of an older tree, with its
                      probe_common.cuh and ../traverse_common.cuh (the C
                      interface `dpt_probe_crossbar_sublane(x, sub, iters,
                      out, stream)`, `dpt_probe_crossbar_lanes(x, idx, K,
                      iters, out, stream)`, `dpt_probe_crossbar_fused(x,
                      lane, srow, iters, out, stream)` and
                      `dpt_probe_crossbar_rows(tab, n_rows, rows, iters,
                      out, stream)`), e.g. unpacked by `git archive
                      <commit> dpt_tpu_torch/csrc | tar -x -C
                      dpt_tpu_torch/_build/old`; built alone by
                      `kernels/build.build` (the probe library's flags) and
                      timed as "old" in the same turns.  P3's
                      `dpt_probe_gather_axis1` / `_axis0(x, idx, iters,
                      out, stream)` come from DIR/gather.cu, built alone
                      beside it, where DIR has one (the trees before P3
                      moved into crossbar.cu), else from DIR's crossbar.cu.
  --sass              each build's step loops in the machine code
                      (`cuobjdump -sass`, `probes.sass.loop_counts`): of
                      each kernel, the loop over the most shared loads
                      (LDS; for D, over the most float adds), its steps
                      (its FADD over K), and its instructions, LDS and
                      global loads (LDG) a step.  For the old and ldg
                      builds' D that loop is the one over chunks of row
                      starts, so its counts a step include their set-up.
                      P3-a's loop in this tree is P4-b's at K = 1.

Prints the card's name and power limit, one line per kernel and pattern
or row count (the median of the rounds' medians, ns a step, each other
build's time over this tree's), each build's time at 0 steps on the seeded
tile or at 0 rows (the launch and the fill or ring set-up alone) and its
loop's ns a step (the seeded or 2,000-row time less that), each build's
one-bank and identity times over its seeded time, each kernel's latency
bound (its steps x K dependent adds at the card's clocks a dependent
operation, `probe_crossbar.op_cycles`), and one JSON line.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dpt_tpu_torch import probes  # noqa: E402
from dpt_tpu_torch.kernels import build  # noqa: E402
from dpt_tpu_torch.probes import probe_crossbar as p4  # noqa: E402
from dpt_tpu_torch.probes import probe_gather as p3  # noqa: E402
from dpt_tpu_torch.probes import sass  # noqa: E402

GATHERS = ("gather_axis1", "gather_axis0")
GATHER_TILE = {"gather_axis1": "idx", "gather_axis0": "idx0"}  # index tile
KERNELS = ("sublane", *(f"lanes_K{K}" for K in p4.KS), "fused", "rows",
           *GATHERS)
ROW_COUNTS = ("2000", "2003")
TIMED_LAUNCHES = 20
ROUNDS = 3
# D's step loop before the ring (the first port's, over one block of 1024
# threads), over kRowsThreads-thread blocks: the row starts staged in
# shared memory 1,024 at a time, one plain load (LDG) a step, @U@ steps'
# loads in flight and their adds in the order of k.
LDG_ROWS = """__global__ void __launch_bounds__(kRowsThreads) rows_kernel(
    const float* __restrict__ tab, int n_rows, const int* __restrict__ rows,
    int iters, float* __restrict__ out) {
  constexpr int kChunk = 1024, U = @U@;
  __shared__ int start[kChunk];
  const int t = static_cast<int>(threadIdx.x);
  const int e = static_cast<int>(blockIdx.x) * kRowsThreads + t;
  const float* tab0 = tab + e;
  float acc = 0.f;
  for (int k0 = 0; k0 < iters; k0 += kChunk) {
    const int n = min(kChunk, iters - k0);
    sync_rows_block();
    for (int j = t; j < n; j += kRowsThreads) {
      const int r8 = static_cast<int>(
          static_cast<unsigned>(__ldg(rows + k0 + j)) * kRows);
      start[j] = dyn_start(r8, n_rows, kRows) * kLanes;
    }
    sync_rows_block();
    int j = 0;
    for (; j + U <= n; j += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldg(tab0 + start[j + u]);
#pragma unroll
      for (int u = 0; u < U; ++u) acc = acc + v[u];
    }
    for (; j < n; ++j) acc = acc + __ldg(tab0 + start[j]);
  }
  out[e] = acc;
}
"""
# P3-b 8 elements a thread: block b of one warp holds rows r0, r0 + 8, ...,
# r0 + 56 (r0 = b / 4) of its 32 columns, the same column copy as
# `column_kernel`, and runs the 8 sums side by side, a group of U steps of
# each read from one base, each lookup a volatile load.
CHAINS8_COLUMN = """__global__ void __launch_bounds__(kColumnThreads) column_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, int iters,
    float* __restrict__ out) {
  constexpr int T = kColumnThreads, U = kColumnGroup, C = 8;
  constexpr int kStride = kRows0 / C;  // between a thread's rows
  __shared__ float xs[(kRows0 + U - 1) * T];
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  const int r0 = b / (kLanes / T);
  const int c = b % (kLanes / T) * T + t;
  float v[kRows0];
#pragma unroll
  for (int j = 0; j < kRows0; ++j) v[j] = __ldg(x + j * kLanes + c);
#pragma unroll
  for (int j = 0; j < kRows0 + U - 1; ++j) xs[j * T + t] = v[j % kRows0];
  unsigned j0[C];
  float acc[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    j0[q] = static_cast<unsigned>(__ldg(idx + (r0 + q * kStride) * kLanes + c));
    acc[q] = 0.f;
  }
  __syncwarp();
  const volatile float* xl = xs + t;  // a load a lookup, as column_kernel
  const int groups = iters / U;
  for (int h = 0; h < groups; ++h) {
    const unsigned k = static_cast<unsigned>(h) * U;
    const volatile float* p[C];
#pragma unroll
    for (int q = 0; q < C; ++q) p[q] = xl + ((j0[q] + k) & (kRows0 - 1)) * T;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int q = 0; q < C; ++q) acc[q] = acc[q] + p[q][u * T];
    }
  }
  for (int k = groups * U; k < iters; ++k) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      acc[q] = acc[q] + xl[((j0[q] + static_cast<unsigned>(k)) &
                            (kRows0 - 1)) * T];
    }
  }
#pragma unroll
  for (int q = 0; q < C; ++q) out[(r0 + q * kStride) * kLanes + c] = acc[q];
}
"""


def _const(name, value):
    """An edit that sets `constexpr int name` to value."""
    return (rf"constexpr int {name} = -?\d+;", f"constexpr int {name} = {value};")


def _kernel(name, text):
    """An edit that puts `text` in place of kernel `name`'s definition, to
    its closing brace at column 0."""
    return (rf"__global__ void __launch_bounds__\(\w+\) {name}\(.*?\n}}\n",
            text)


# The edited copies of this tree's crossbar.cu: name -> (the edits, each a
# regex of crossbar.cu's text matching once and its replacement; the
# kernels timed).
EDITS = {
    "w128": ((_const("kSublaneThreads", 128), _const("kRowsThreads", 128)),
             ("sublane", "rows")),
    **{f"ldg{u}": ((_kernel("rows_kernel", LDG_ROWS.replace("@U@", str(u))),),
                   ("rows",))
       for u in (8, 16, 32)},
    "chains8": ((_kernel("column_kernel", CHAINS8_COLUMN),
                 (r"column_kernel<<<kTile0 / kColumnThreads,",
                  "column_kernel<<<kTile0 / kColumnThreads / 8,")),
                ("gather_axis0",)),
}
# kernel -> the regexes of its function's name in the machine code, the
# first found taken (P3's in an older tree's gather.cu, else in
# crossbar.cu)
FUNCTIONS = {"sublane": (r"sublane_kernel",), "fused": (r"fused_kernel",),
             "rows": (r"rows_kernel",),
             **{f"lanes_K{K}": (rf"lanes_kernelILi{K}E",) for K in p4.KS},
             "gather_axis1": (r"gather_axis1_kernel", r"lanes_kernelILi1E"),
             "gather_axis0": (r"gather_axis0_kernel", r"column_kernel")}
# kernel -> what its step loop is the loop over the most of: shared loads
# for the lookups, float adds for D (whose loop over chunks holds the step
# loop and more shared loads)
STEP_LOOP_BY = {k: ("FADD",) if k == "rows" else ("LDS",) for k in FUNCTIONS}


def sources(probe_dir: pathlib.Path, source="crossbar.cu"):
    return [probe_dir / source, probe_dir / "probe_common.cuh",
            probe_dir.parent / "traverse_common.cuh"]


def edited_copy(name) -> pathlib.Path:
    """This tree's csrc/probes/crossbar.cu edited as `EDITS[name]` says,
    and the headers it includes, under _build/crossbar_<name>/probes."""
    edits, _ = EDITS[name]
    text = (build.PROBE_CSRC / "crossbar.cu").read_text()
    for pattern, new in edits:
        text, n = re.subn(pattern, lambda _m, new=new: new, text,
                          flags=re.S)
        if n != 1:
            sys.exit(f"crossbar.cu has {n} matches of {pattern!r} to edit, "
                     "not one")
    d = build.BUILD_DIR / f"crossbar_{name}" / "probes"
    d.mkdir(parents=True, exist_ok=True)
    (d / "crossbar.cu").write_text(text)
    shutil.copy(build.PROBE_CSRC / "probe_common.cuh", d)
    shutil.copy(build.CSRC / "traverse_common.cuh", d.parent)
    return d


def steps_of(kernel, case="2000"):
    """(steps, dependent adds a step) of a kernel at the TPU script's
    ITERS (D: at `case` rows; P3 at its script's 1,000 and 100)."""
    if kernel == "rows":
        return (int(case) if case.isdigit() else int(ROW_COUNTS[0])), 1
    if kernel in GATHERS:
        return (p3.ITERS_AXIS1 if kernel == "gather_axis1"
                else p3.ITERS_AXIS0), 1
    if kernel in ("sublane", "fused"):
        return p4.ITERS, 1
    K = int(kernel.split("_K")[1])
    return p4.ITERS // K, K


def cases_of(kernel):
    """The timed cases of a kernel: the index patterns, or D's row counts,
    and "none": 0 steps (the seeded tile) or 0 rows."""
    return (*(ROW_COUNTS if kernel == "rows" else p4.PATTERNS), "none")


class Library:
    """The C interface of a crossbar.cu built alone at `lib_path`, with P3's
    from `gather_path` (an older tree's gather.cu built alone) or, without
    it, from the crossbar.cu where it has them."""

    def __init__(self, lib_path, gather_path=None):
        self.name = pathlib.Path(lib_path).name
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, args in (("sublane", [p, p, i, p, p]),
                         ("lanes", [p, p, i, i, p, p]),
                         ("fused", [p, p, p, i, p, p]),
                         ("rows", [p, i, p, i, p, p])):
            f = getattr(lib, f"dpt_probe_crossbar_{fn}")
            f.argtypes = args
            f.restype = i
        glib = lib if gather_path is None else ctypes.CDLL(str(gather_path))
        self.gathers = {}
        for k in GATHERS:
            f = getattr(glib, f"dpt_probe_{k}", None)
            if f is not None:
                f.argtypes = [p, p, i, p, p]
                f.restype = i
                self.gathers[k] = f
        self.lib = lib

    def has(self, kernel):
        return kernel not in GATHERS or kernel in self.gathers

    def _check(self, kernel, err):
        if err:
            raise RuntimeError(f"{self.name} {kernel}: cudaError {err}")

    def lookup(self, kernel, x, t, steps):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        if kernel in GATHERS:
            err = self.gathers[kernel](
                x.data_ptr(), t[GATHER_TILE[kernel]].data_ptr(), steps,
                out.data_ptr(), stream)
        elif kernel == "sublane":
            err = self.lib.dpt_probe_crossbar_sublane(
                x.data_ptr(), t["srow"].data_ptr(), steps, out.data_ptr(),
                stream)
        elif kernel == "fused":
            err = self.lib.dpt_probe_crossbar_fused(
                x.data_ptr(), t["lane"].data_ptr(), t["srow"].data_ptr(),
                steps, out.data_ptr(), stream)
        else:
            err = self.lib.dpt_probe_crossbar_lanes(
                x.data_ptr(), t["idx"].data_ptr(), steps_of(kernel)[1],
                steps, out.data_ptr(), stream)
        self._check(kernel, err)
        return out

    def rows(self, tab, rows):
        out = torch.empty((p4.ROWS, p4.LANES), dtype=torch.float32,
                          device=tab.device)
        err = self.lib.dpt_probe_crossbar_rows(
            tab.data_ptr(), tab.shape[0], rows.data_ptr(), rows.shape[0],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        self._check("rows", err)
        return out


class Tree:
    """This tree's kernels, through the public wrappers."""

    @staticmethod
    def has(kernel):
        return True

    @staticmethod
    def lookup(kernel, x, t, steps):
        if kernel == "gather_axis1":
            return p3.axis1_gather(x, t["idx"], steps)
        if kernel == "gather_axis0":
            return p3.axis0_gather(x, t["idx0"], steps)
        if kernel == "sublane":
            return p4.sublane_gather(x, t["srow"], steps)
        if kernel == "fused":
            return p4.fused_lookup(x, t["lane"], t["srow"], steps)
        K = steps_of(kernel)[1]
        return p4.lane_gathers(x, t["idx"], K, steps * K)

    @staticmethod
    def rows(tab, rows):
        return p4.row_blocks(tab, rows)


def plain(kernel, x, t, steps):
    if kernel == "gather_axis1":
        return p3.axis1_gather_reference(x, t["idx"], steps)
    if kernel == "gather_axis0":
        return p3.axis0_gather_reference(x, t["idx0"], steps)
    if kernel == "sublane":
        return p4.sublane_gather_reference(x, t["srow"], steps)
    if kernel == "fused":
        return p4.fused_lookup_reference(x, t["lane"], t["srow"], steps)
    return p4.lane_gathers_reference(x, t["idx"], steps_of(kernel)[1], steps)


def step_loops(lib_paths, kernels):
    """{kernel: counts} of built libraries' step loops
    (`probes.sass.loop_counts`, by shared loads)."""
    text = "".join(sass.dump(path) for path in lib_paths)
    out = {}
    for k in kernels:
        for function in FUNCTIONS[k]:
            found = sass.loop_counts(text, function, adds=steps_of(k)[1],
                                     loads=STEP_LOOP_BY[k])
            if found:
                out[k] = found[0][1]
                break
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
    paths = {"tree": [build.library_path("libdpt_probes",
                                         build._probe_sources())]}
    calls = {"tree": Tree}
    if args.old is not None:
        paths["old"] = [build.build("libdpt_crossbar_old", sources(args.old))]
        if (args.old / "gather.cu").exists():
            paths["old"].append(build.build(
                "libdpt_gather_old", sources(args.old, "gather.cu")))
        calls["old"] = Library(*paths["old"])
    for name in EDITS:
        paths[name] = [build.build(f"libdpt_crossbar_{name}",
                                   sources(edited_copy(name)))]
        calls[name] = Library(*paths[name])

    def builds_of(kernel):
        return [b for b in calls if (b not in EDITS or kernel in EDITS[b][1])
                and calls[b].has(kernel)]

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(p4.ROWS, p4.LANES))
                        .astype(np.float32), device=dev)
    tiles = {name: {k: torch.as_tensor(v, device=dev) for k, v in t.items()}
             for name, t in p4.index_patterns(rng).items()}
    for name, t in p3.row_patterns(rng).items():
        tiles[name]["idx0"] = torch.as_tensor(t, device=dev)
    tiles["none"] = tiles["seeded"]
    x0 = torch.as_tensor(rng.normal(size=(p3.ROWS_AXIS0, p3.LANES))
                         .astype(np.float32), device=dev)
    a = p4.inputs(np.random.default_rng(0),
                  iters=max(int(n) for n in ROW_COUNTS))
    tab = torch.as_tensor(a["tab"], device=dev)
    rows_of = {n: torch.as_tensor(a["rows"][:int(n)], device=dev)
               for n in ROW_COUNTS}
    rows_of["none"] = rows_of[ROW_COUNTS[0]][:0]
    configs = [(b, k, case) for k in KERNELS for case in cases_of(k)
               for b in builds_of(k)]

    def run(b, k, case):
        if k == "rows":
            return calls[b].rows(tab, rows_of[case])
        return calls[b].lookup(k, x0 if k == "gather_axis0" else x,
                               tiles[case],
                               0 if case == "none" else steps_of(k)[0])

    refs = {}
    for b, k, case in configs:
        if (k, case) not in refs:
            refs[k, case] = (
                p4.row_blocks_reference(tab, rows_of[case]) if k == "rows"
                else plain(k, x0 if k == "gather_axis0" else x, tiles[case],
                           0 if case == "none" else steps_of(k)[0]))
        got = run(b, k, case)
        torch.cuda.synchronize()
        if not torch.equal(got, refs[k, case]):
            raise AssertionError(f"{b} {k} {case} differs from its plain "
                                 "version")
    print(f"exact: {len(configs)} launches (builds {list(calls)}) equal "
          "their plain versions", flush=True)
    cycles, ends = p4.op_cycles(x)
    if not torch.equal(ends.cpu(), p4.op_chain_reference(x.cpu())):
        raise AssertionError("the bare chain differs from its plain version")

    rounds = {c: [] for c in configs}
    for r in range(ROUNDS):
        for c in (configs if r % 2 == 0 else configs[::-1]):
            rounds[c].append(statistics.median(probes.launch_ms(
                lambda c=c: run(*c), [()], n=TIMED_LAUNCHES)))
    ms = {c: statistics.median(v) for c, v in rounds.items()}

    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "rounds": ROUNDS, "cycles_per_op": cycles, "ms": {},
              "rounds_ms": {}, "pattern_ratio": {}, "latency_bound_ms": {},
              "loop_ns_per_step": {}, "fixed_ms": {}}
    for k in KERNELS:
        builds = builds_of(k)
        timed = cases_of(k)[:-1]
        for case in timed:
            steps, chain = steps_of(k, case)
            tree = ms["tree", k, case]
            line = ", ".join(
                f"{b} {ms[b, k, case]:.4f} ({ms[b, k, case] / tree:.2f}x)"
                for b in builds[1:])
            print(f"[time] {k} {case}: tree {tree:.4f} ms "
                  f"({tree * 1e6 / steps:.1f} ns a step; rounds "
                  f"{min(rounds['tree', k, case]):.4f}-"
                  f"{max(rounds['tree', k, case]):.4f})"
                  + (f"; {line}" if line else ""), flush=True)
            bound = probes.latency_bound_ms(steps, chain, cycles)
            result["latency_bound_ms"][f"{k} {case}"] = bound
            print(f"[bound] {k} {case}: {steps} steps x {chain} dependent "
                  f"adds at the card's {cycles:.4f} clocks an operation: "
                  f"{bound:.5f} ms, {100 * bound / tree:.3g}% of the tree's "
                  "time", flush=True)
        for case in cases_of(k):
            for b in builds:
                result["ms"][f"{b} {k} {case}"] = ms[b, k, case]
                result["rounds_ms"][f"{b} {k} {case}"] = rounds[b, k, case]
        first = timed[0]
        steps = steps_of(k, first)[0]
        loop = {b: (ms[b, k, first] - ms[b, k, "none"]) * 1e6 / steps
                for b in builds}
        result["loop_ns_per_step"][k] = loop
        result["fixed_ms"][k] = {b: ms[b, k, "none"] for b in builds}
        print(f"[fixed] {k} at 0 steps (the launch and its set-up): "
              + ", ".join(f"{b} {ms[b, k, 'none']:.4f} ms" for b in builds)
              + f"; the loop, {first} less that, ns a step: "
              + ", ".join(f"{b} {v:.2f}" for b, v in loop.items()),
              flush=True)
        if k == "rows":
            continue
        for b in builds:
            seeded = ms[b, k, "seeded"]
            ratios = {pat: ms[b, k, pat] / seeded for pat in p4.PATTERNS[1:]}
            result["pattern_ratio"][f"{b} {k}"] = ratios
            print(f"[pattern] {b} {k}: " + ", ".join(
                f"{pat} / seeded {v:.3f}" for pat, v in ratios.items()),
                flush=True)
    if args.sass:
        result["sass"] = {}
        for b in calls:
            kernels = [k for k in KERNELS if b in builds_of(k)]
            loops = step_loops(paths[b], kernels)
            if sorted(loops) != sorted(kernels):
                sys.exit(f"{b}: found the step loops of {sorted(loops)} in "
                         f"the machine code, not of every one of {kernels}")
            result["sass"][b] = loops
            for k, c in loops.items():
                print(f"[sass] {b} {k}: {c['per_step']:.2f} instructions a "
                      f"step, {c['lds_per_step']:.2f} LDS and "
                      f"{c['ldg_per_step']:.2f} LDG a step "
                      f"({c['loop_instructions']} in a loop of "
                      f"{c['steps']:g} steps); " + ", ".join(
                          f"{o} {n:.2f}" for o, n in
                          list(c["by_opcode"].items())[:10]),
                      flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

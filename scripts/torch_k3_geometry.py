"""Kernel times of K3 (csrc/intersect_nearest.cu) in every geometry it is
built for: how the wrapper's rule (dpt_tpu_torch/kernels/intersect.py
`_geometry`) was set.

    python scripts/torch_k3_geometry.py [--streams primary:512,box:65536,...]
        [--inputs 3] [--rounds 2] [--old CSRC_DIR] [--sass]

Streams (`--streams`, comma-separated; the default is the streams the
repo's paths send K3): `primary:RES` is box512's primary stream at RES x
RES over the box (12 triangles, 2 table rows; 12 is the oracle render's);
`box:N` is N rays leaving the box's surfaces in uniform directions
(box512's compacted chunk is 65,536 of them); `sphere:N` is N such rays
over the procedural sphere of 3,720 triangles (465 rows; phase 9's
incoherent stream of chip_smoke.py is 65,536); `rows:M:N` is the
`sphere:N` rays over the first M rows of the sphere's table (where a
table starts to pay for a cluster).  `--inputs` of each, made from fixed
seeds.

For each stream, every geometry of `GEOMETRIES` (rays per thread x blocks
per cluster x threads per block) is first checked against the plain
version on every input, hit, tri and t exactly; then each is timed: the
kernel's mean device time per launch from torch.profiler over the inputs,
one window per geometry, the geometries in turns over `--rounds` rounds
(the order reversed every round), and the mean of the rounds.  `--old
DIR` builds the K3 source of an older tree (`DIR/intersect_nearest.cu`
with its `traverse_common.cuh`: the earlier one-thread-per-ray kernel and
its C interface, e.g. from `git archive` of a commit before the redesign)
into a library of its own (kernels/build.py `build`) and times it in the
same turns as "old", after the same check.  Prints the card's name and
power limit, one line per stream and geometry (kernel ms, share of the
bound, registers, dynamic shared memory, blocks per SM), the fastest
geometry of each stream beside the one `_geometry` picks; with `--sass`,
the instruction counts of each K3 instantiation in the built libraries
(`cuobjdump -sass`): all of the function and its row loop (the innermost
loop around the slot loads), by opcode, and the row loop's per slot test
(its count over 8 x R; each test also holds a call of the IEEE
reciprocal's slow path and its set-up, which a finite ray never takes).
Ends with one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dpt_tpu_torch.kernels import build  # noqa: E402
from dpt_tpu_torch.kernels import intersect as K  # noqa: E402

DEFAULT_STREAMS = "primary:512,box:65536,sphere:65536,primary:12"


def make_stream(spec, scenes, n, dev):
    """(the table, the `n` inputs (o, d)) of one `--streams` entry."""
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.scene.camera import OrbitCamera

    kind, *sizes = spec.split(":")
    size = int(sizes[-1])
    if kind == "rows":
        _, inputs = make_stream(f"sphere:{size}", scenes, n, dev)
        return scenes["sphere"][:int(sizes[0])], inputs
    if kind == "primary":
        cfg = preset("box512", width=size, height=size)
        camera = OrbitCamera().camera(dev)
        return scenes["box"], [chip_smoke.primary_rays(camera, cfg, b,
                                                       300 + b, dev)[:2]
                               for b in range(n)]
    return scenes[kind], [chip_smoke.incoherent_rays(
        scenes[kind + "_scene"], size, 400 + k, dev)[:2] for k in range(n)]


def old_launcher(csrc):
    """(a launch (o, d, tris, eps) -> (t, tri) through the earlier
    one-thread-per-ray C interface of DIR/intersect_nearest.cu, built alone,
    and the library's path)."""
    path = build.build("libk3_old", [pathlib.Path(csrc) / f for f in (
        "intersect_nearest.cu", "traverse_common.cuh")])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(str(path)).dpt_intersect_nearest
    fn.restype = i
    fn.argtypes = [p, p, p, i, i, ctypes.c_float, p, p, p]

    def run(o, d, tris, eps):
        n = o.shape[0]
        t = torch.empty((n,), dtype=torch.float32, device=o.device)
        tri = torch.empty((n,), dtype=torch.int32, device=o.device)
        err = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (o, d, tris)),
                 n, tris.shape[0], ctypes.c_float(eps),
                 ctypes.c_void_p(t.data_ptr()), ctypes.c_void_p(tri.data_ptr()),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"K3 launch: cudaError {err}")
        return t, tri

    return run, path


def sass_counts(lib_path):
    """{"R<r> S<s>": {"all": Counter, "loop": Counter}} of each K3
    instantiation in the library (the untemplated kernel of an older
    build as "old R1"), from `cuobjdump -sass`."""
    cuobjdump = pathlib.Path(build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        m = re.search(r"intersect_nearest_kernel(ILi(\d+)ELi(\d+)E)?", name)
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

        def opcode(text):
            return text.split()[1 if text.startswith("@") else 0]

        # The row loop: the innermost backward branch around the slot
        # loads (LDS.128 from the ring, LDG.E.128 in the older kernel).
        best = None
        for k, (_, text) in enumerate(instrs):
            if opcode(text) != "BRA":
                continue
            tgt = re.search(r"`\((\.L_x_\d+)\)|BRA\s+(0x[0-9a-f]+)", text)
            if tgt is None:
                continue
            j = (labels.get(tgt.group(1)) if tgt.group(1)
                 else addr_index.get(int(tgt.group(2), 16)))
            if (j is not None and j <= k
                    and any(opcode(t).startswith(("LDS.128", "LDG.E.128"))
                            for _, t in instrs[j:k + 1])
                    and (best is None or k - j < best[1] - best[0])):
                best = (j, k)
        best = best or (0, -1)
        # The earlier one-thread-per-ray kernel has no template.
        label = f"R{m.group(2)} S{m.group(3)}" if m.group(1) else "old R1"
        out[label] = {
            "all": collections.Counter(opcode(t) for _, t in instrs),
            "loop": collections.Counter(opcode(t) for _, t in
                                        instrs[best[0]:best[1] + 1]),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", default=DEFAULT_STREAMS)
    ap.add_argument("--inputs", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--old", default=None)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.scene.builder import cornell_box_scene, procedural_scene

    chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    eps = preset("box512").eps
    box = cornell_box_scene(device=dev)
    sphere = procedural_scene(chip_smoke.K3_TRIS_TARGET, device=dev)
    scenes = {"box": K.pack_tris(*box.tri_vertices()), "box_scene": box,
              "sphere": K.pack_tris(*sphere.tri_vertices()),
              "sphere_scene": sphere}
    names = {chip_smoke.k3_geometry_name(g): g for g in K.GEOMETRIES}
    runs = {name: (lambda g: lambda o, d, tris: K._launch(o, d, tris, eps,
                                                           g))(g)
            for name, g in names.items()}
    libs = [build.build()]
    if args.old:
        old, path = old_launcher(args.old)
        libs.append(path)
        runs["old"] = lambda o, d, tris: old(o, d, tris, eps)
    report = {"card": torch.cuda.get_device_name(0), "streams": {}}
    for spec in args.streams.split(","):
        tris, inputs = make_stream(spec, scenes, args.inputs, dev)
        for o, d in inputs:
            ph, pt, pi = K.intersect_nearest_reference(o, d, tris, eps)
            for label, run in runs.items():
                t, i = run(o, d, tris)
                torch.cuda.synchronize()
                if not (torch.equal(t < K.T_MAX, ph) and torch.equal(t, pt)
                        and torch.equal(i, pi)):
                    raise SystemExit(f"{spec} {label}: differs from the "
                                     "plain version")
        times = collections.defaultdict(list)
        order = list(runs)
        for rnd in range(args.rounds):
            for label in (order if rnd % 2 == 0 else order[::-1]):
                run = runs[label]
                times[label].append(chip_smoke.kernel_device_ms(
                    {label: lambda o, d, run=run: run(o, d, tris)}, inputs,
                    "intersect_nearest", design=lambda _, lab=label: lab)[
                        label])
        n_rays, n_rows = inputs[0][0].shape[0], tris.shape[0]
        n_tris = int(tris.reshape(-1, 16)[:, 10].sum())
        bound_ms, by = chip_smoke.k3_bound(n_rays, n_rows, n_tris)
        picked = chip_smoke.k3_geometry_name(K._geometry(n_rays, n_rows))
        rows = {}
        for label in runs:
            ms = statistics.fmean(times[label])
            rows[label] = {"kernel_ms": ms, "rounds": times[label],
                           "bound_share": bound_ms / ms}
            if label in names:
                rows[label].update(build.intersect_attributes(
                    names[label], n_rows))
            a = rows[label]
            print(f"[k3 {spec}] {label}: kernel {ms:.4f} ms (rounds "
                  + ", ".join(f"{x:.4f}" for x in times[label])
                  + f"), {bound_ms / ms:.1%} of the bound {bound_ms:.4f} "
                  f"by {by}"
                  + (f"; {a['num_regs']} regs, {a['local_bytes']} local, "
                     f"{a['smem_bytes']} smem, {a['blocks_per_sm']} "
                     f"blocks/SM, {a['max_clusters']} clusters at once"
                     if "num_regs" in a else ""), flush=True)
        fastest = min((lab for lab in rows if lab in names),
                      key=lambda lab: rows[lab]["kernel_ms"])
        print(f"[k3 {spec}] R={n_rays}, {n_rows} rows, {n_tris} "
              f"triangles: fastest {fastest} "
              f"{rows[fastest]['kernel_ms']:.4f} ms; _geometry picks "
              f"{picked} {rows[picked]['kernel_ms']:.4f} ms"
              + (f"; old {rows['old']['kernel_ms']:.4f} ms" if "old" in rows
                 else ""), flush=True)
        report["streams"][spec] = {"n_rays": n_rays, "n_rows": n_rows,
                                   "n_tris": n_tris,
                                   "bound_ms": bound_ms, "bound_by": by,
                                   "picked": picked, "fastest": fastest,
                                   "geometries": rows}
    if args.sass:
        counts = {}
        for path in libs:
            counts.update(sass_counts(path))
        for name, c in sorted(counts.items()):
            R = int(re.search(r"R(\d+)", name).group(1))
            loop = sum(c["loop"].values())
            print(f"[sass {name}] {sum(c['all'].values())} instructions, row "
                  f"loop {loop} ({loop / (8 * R):.1f} a slot test, with "
                  f"{c['loop']['CALL.REL.NOINC']} calls of the reciprocal's "
                  "slow path): "
                  + ", ".join(f"{k} {v}" for k, v in c["loop"].most_common()),
                  flush=True)
        report["sass"] = {k: {part: dict(v) for part, v in c.items()}
                          for k, c in counts.items()}
    print(json.dumps(report))


if __name__ == "__main__":
    main()

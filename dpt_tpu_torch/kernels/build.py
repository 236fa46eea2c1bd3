"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own `nvcc`, all at once, and the objects are
linked into one shared library with a plain C interface, loaded with
ctypes; nothing includes PyTorch's headers, so a build takes seconds.  The
library goes to `dpt_tpu_torch/_build/` under a name keyed by a hash of the
sources and flags, so an edited source is never served a stale build.
Nothing here runs at import: the package is also imported where there is
no `nvcc`, and a build happens only when a CUDA tensor reaches a kernel
wrapper.  `launch_walk` calls a BVH walk kernel (K1 in either design,
K2) through its C interface, `launch_intersect` the brute-force search (K3).

The probes (csrc/probes/*.cu, the H100 forms of the TPU probes under
scripts/) build the same way into a second library,
`libdpt_probes_<hash>.so` (`load_probe_library`), at first use by a probe
module (dpt_tpu_torch/probes/); the render's library and its hash do not
include them.

`-fmad=false` keeps every multiply and add separately rounded, so a kernel
and its plain PyTorch version (separate elementwise ops) agree exactly on
the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
PROBE_CSRC = CSRC / "probes"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

# The BVH walks, each exported as `dpt_<name>` (the launch, same signature
# for all, `launch_walk`) and `dpt_<name>_attrs`: K1 (pallas_quad,
# csrc/quad_traverse.cu) one ray per lane and one ray per group of four
# lanes (a child's slab and two leaf slots each), and K2 (pallas_wide,
# csrc/wide_traverse.cu).
WALKS = ("quad_traverse", "quad_traverse_group", "wide_traverse")
# The brute-force search K3 (pallas_intersect), exported by
# csrc/intersect_nearest.cu as `dpt_intersect_nearest` (rays, table, ray
# and row counts, eps, outputs, then the geometry and the grid:
# `launch_intersect`) and `dpt_intersect_nearest_attrs` (per geometry and
# table size: `intersect_attributes`).
INTERSECT = "intersect_nearest"
# Every kernel of the library -> its modes.
KERNEL_MODES = {**{k: ("nearest", "occluded") for k in WALKS},
                INTERSECT: ("nearest",)}

_lib = None
_probe_lib = None
# Wall seconds the last call to `build` spent compiling (0.0 when the
# library was already built).
build_seconds = 0.0


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin, on PATH or in /usr/local/cuda/bin;"
        " the CUDA kernels cannot be built")


def _sources():
    """The render library's sources: csrc/*.cu and csrc/*.cuh."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _probe_sources():
    """The probe library's sources, and the header they include."""
    return (sorted(PROBE_CSRC.glob("*.cu")) + sorted(PROBE_CSRC.glob("*.cuh"))
            + [CSRC / "traverse_common.cuh"])


def library_path(stem="libdpt_tpu_torch", sources=None) -> pathlib.Path:
    """`_build/<stem>_<hash>.so`, keyed by the sources (default: the render
    library's) and the flags."""
    h = hashlib.sha256()
    for p in _sources() if sources is None else sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Start every command at once, wait for all; raise on the first that
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    for c, text, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{text}")


def build(stem="libdpt_tpu_torch", sources=None) -> pathlib.Path:
    """Compile the .cu files of `sources` (default: the render library's,
    csrc/*.cu) into the keyed library unless it exists: one nvcc per
    source, all started together, then one link."""
    global build_seconds
    sources = _sources() if sources is None else sources
    out = library_path(stem, sources)
    build_seconds = 0.0
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = [p for p in sources if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
              for p, o in zip(srcs, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The built kernel library, with argtypes declared (built on first
    call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in WALKS:
        launch = getattr(lib, f"dpt_{name}")
        launch.argtypes = [p, p, p, p, p, i, i, p, p, p]
        launch.restype = i
    launch = getattr(lib, f"dpt_{INTERSECT}")
    launch.argtypes = [p, p, p, i, i, ctypes.c_float, p, p, i, i, i, i, p]
    launch.restype = i
    for name in WALKS:
        attrs = getattr(lib, f"dpt_{name}_attrs")
        attrs.argtypes = [i, *[ctypes.POINTER(i)] * 3]
        attrs.restype = i
    attrs = getattr(lib, f"dpt_{INTERSECT}_attrs")
    attrs.argtypes = [i, i, i, i, *[ctypes.POINTER(i)] * 5]
    attrs.restype = i
    lib.dpt_cuda_error_string.argtypes = [i]
    lib.dpt_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def load_probe_library() -> ctypes.CDLL:
    """The probes' library (csrc/probes/*.cu), with argtypes declared
    (built on first call)."""
    global _probe_lib
    if _probe_lib is not None:
        return _probe_lib
    lib = ctypes.CDLL(str(build("libdpt_probes", _probe_sources())))
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    # The primitive probes (gather.cu, crossbar.cu, features.cu): the
    # tiles, then out and the stream.
    tile_iters = [p, p, i, p, p]  # x, index tile, iters | idx, table, dim
    for name, args in (
            ("dpt_quad_traverse_smem", [p, p, p, p, i, i, i, p, p, p]),
            ("dpt_quad_traverse_smem_attrs", [i, i, ip, ip, ip]),
            ("dpt_probe_interleave", [p, p, i, i, i, p, p, p]),
            ("dpt_probe_interleave2", [p, p, p, i, i, i, p, p, p]),
            ("dpt_probe_gather_axis1", tile_iters),
            ("dpt_probe_gather_axis0", tile_iters),
            ("dpt_probe_crossbar_sublane", tile_iters),
            ("dpt_probe_crossbar_lanes", [p, p, i, i, p, p]),
            ("dpt_probe_crossbar_fused", [p, p, p, i, p, p]),
            ("dpt_probe_crossbar_rows", [p, i, p, i, p, p]),
            ("dpt_probe_crossbar_math", [p, i, p, p]),
            *((f"dpt_probe_{k}", tile_iters) for k in (
                "scalar_load", "scalar_extract", "dyn_lane_slice",
                "dyn_roll", "scalar_dyn_lane", "dyn_sublane_row")),
            ("dpt_probe_smem_stack", [p, p]),
            ("dpt_probe_int_vector_ops", [p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    lib.dpt_cuda_error_string.argtypes = [i]
    lib.dpt_cuda_error_string.restype = ctypes.c_char_p
    _probe_lib = lib
    return lib


def kernel_attributes(kernel: str, occluded: bool) -> dict:
    """Registers and local bytes per thread, and resident blocks per SM, of
    one walk kernel of WALKS in one mode (K3's: `intersect_attributes`)."""
    if kernel == INTERSECT:
        raise ValueError(f"{INTERSECT} has a geometry and a table size: "
                         "use intersect_attributes")
    modes = KERNEL_MODES.get(kernel)
    if modes is None:
        raise ValueError(f"unknown kernel {kernel!r}; known: "
                         f"{tuple(KERNEL_MODES)}")
    if ("occluded" if occluded else "nearest") not in modes:
        raise ValueError(f"{kernel} has only the modes {modes}")
    lib = load_library()
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = getattr(lib, f"dpt_{kernel}_attrs")(
        int(occluded), *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return dict(zip(("num_regs", "local_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def intersect_attributes(geometry, n_rows: int) -> dict:
    """Registers and local bytes per thread, resident blocks per SM,
    dynamic shared memory bytes and the clusters the card holds at once,
    of K3 in `geometry` (rays per thread, blocks per cluster, threads per
    block) over a table of n_rows rows."""
    lib = load_library()
    vals = [ctypes.c_int(0) for _ in range(5)]
    err = getattr(lib, f"dpt_{INTERSECT}_attrs")(
        *(int(v) for v in geometry), int(n_rows),
        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"{INTERSECT} attributes at {tuple(geometry)}: "
                           f"cudaError {err}")
    return dict(zip(("num_regs", "local_bytes", "blocks_per_sm",
                     "smem_bytes", "max_clusters"), (v.value for v in vals)))


def check_rays(origin, direction, max_dist=None):
    """Raise unless the rays are float32 [R, 3], [R, 3] and (when given)
    [R] on one device."""
    dev = origin.device
    R = origin.shape[0]
    checks = [("origin", origin, (R, 3)), ("direction", direction, (R, 3))]
    if max_dist is not None:
        checks.append(("max_dist", max_dist, (R,)))
    for name, x, shape in checks:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origin on {dev}")


def launch_walk(kernel, origin, direction, max_dist, nodes, tris,
                occluded: bool):
    """Launch one walk kernel of WALKS on the current stream: (t [R] f32,
    tri [R] int32) in nearest mode, (None, occluded [R] int32) in occluded
    mode, where `max_dist` is read and no t is written.  The caller has
    checked the rays and the tables; this checks the tables' alignment and
    the launch's error."""
    R = origin.shape[0]
    dev = origin.device
    out_i = torch.empty((R,), dtype=torch.int32, device=dev)
    out_t = None if occluded else torch.empty((R,), dtype=torch.float32,
                                              device=dev)
    if R == 0:
        return out_t, out_i
    rays = [x.contiguous() for x in (origin, direction)]
    md = max_dist.contiguous() if occluded else None
    tables = [x.contiguous() for x in (nodes, tris)]
    for x in tables:
        if x.data_ptr() % 16:
            raise ValueError("accel tables must be 16-byte aligned")
    lib = load_library()

    def ptr(x):
        return ctypes.c_void_p(None if x is None else x.data_ptr())

    err = getattr(lib, f"dpt_{kernel}")(
        *map(ptr, (*rays, md, *tables)), ctypes.c_int(R),
        ctypes.c_int(int(occluded)), ptr(out_t), ptr(out_i),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    check_launch(lib, kernel, err)
    return out_t, out_i


def launch_intersect(origin, direction, tris, eps: float, geometry,
                     blocks: int):
    """Launch K3 on the current stream in `geometry` (rays per thread,
    blocks per cluster, threads per block) over `blocks` blocks: (t [R]
    f32, tri [R] int32), t 1e30 and tri 0 on a miss.  The caller has
    checked the rays and the table and computed the grid; this checks the
    table's alignment and the launch's error (a geometry the library does
    not build, a grid that does not cover the rays once, or a refused
    cluster or shared-memory request raises)."""
    R = origin.shape[0]
    out_t = torch.empty((R,), dtype=torch.float32, device=origin.device)
    out_i = torch.empty((R,), dtype=torch.int32, device=origin.device)
    if R == 0:
        return out_t, out_i
    tensors = [x.contiguous() for x in (origin, direction, tris)]
    if tensors[2].data_ptr() % 16:
        raise ValueError("the triangle table must be 16-byte aligned")
    lib = load_library()
    stream = torch.cuda.current_stream(origin.device).cuda_stream
    err = getattr(lib, f"dpt_{INTERSECT}")(
        *(ctypes.c_void_p(x.data_ptr()) for x in tensors),
        ctypes.c_int(R), ctypes.c_int(tris.shape[0]), ctypes.c_float(eps),
        ctypes.c_void_p(out_t.data_ptr()), ctypes.c_void_p(out_i.data_ptr()),
        *(ctypes.c_int(int(v)) for v in geometry), ctypes.c_int(blocks),
        ctypes.c_void_p(stream),
    )
    check_launch(lib, INTERSECT, err)
    return out_t, out_i


def check_launch(lib, kernel, err):
    """Raise unless a launch through `lib` returned cudaSuccess."""
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: cudaError {err} "
            f"({lib.dpt_cuda_error_string(err).decode()})")

"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own `nvcc`, all at once, and the objects are
linked into one shared library with a plain C interface, loaded with
ctypes; nothing includes PyTorch's headers, so a build takes seconds.  The
library goes to `dpt_tpu_torch/_build/` under a name keyed by a hash of the
sources and flags, so an edited source is never served a stale build.
Nothing here runs at import: the package is also imported where there is
no `nvcc`, and a build happens only when a CUDA tensor reaches a kernel
wrapper.  `launch_walk` calls a walk kernel through its C interface.

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
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

# The BVH walks, each exported by csrc/<name>.cu as `dpt_<name>` (the launch,
# same signature for both) and `dpt_<name>_attrs`:
# K1 (pallas_quad) and K2 (pallas_wide).
KERNELS = ("quad_traverse", "wide_traverse")

_lib = None
# Wall seconds the last call to `load_library` spent compiling (0.0 when the
# library was already built or loaded).
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
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdpt_tpu_torch_{h.hexdigest()[:16]}.so"


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


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the keyed library unless it exists: one nvcc
    per source, all started together, then one link."""
    global build_seconds
    out = library_path()
    build_seconds = 0.0
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = [p for p in _sources() if p.suffix == ".cu"]
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
    for name in KERNELS:
        launch = getattr(lib, f"dpt_{name}")
        launch.argtypes = [p, p, p, p, p, i, i, p, p, p]
        launch.restype = i
        attrs = getattr(lib, f"dpt_{name}_attrs")
        attrs.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
        attrs.restype = i
    lib.dpt_cuda_error_string.argtypes = [i]
    lib.dpt_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def kernel_attributes(kernel: str, occluded: bool) -> dict:
    """Registers and local bytes per thread of one kernel of KERNELS in one
    mode."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    lib = load_library()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(lib, f"dpt_{kernel}_attrs")(
        int(occluded), ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return {"num_regs": regs.value, "local_bytes": local.value}


def check_rays(origin, direction, max_dist):
    """Raise unless the rays are float32 [R, 3], [R, 3], [R] on one
    device."""
    dev = origin.device
    R = origin.shape[0]
    for name, x, shape in (("origin", origin, (R, 3)),
                           ("direction", direction, (R, 3)),
                           ("max_dist", max_dist, (R,))):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origin on {dev}")


def launch_walk(kernel, origin, direction, max_dist, nodes, tris,
                occluded: bool):
    """Launch one walk kernel of KERNELS on the current stream: (t [R] f32,
    tri or occluded [R] int32).  The caller has checked the rays and the
    tables; this checks the tables' alignment and the launch's error."""
    R = origin.shape[0]
    out_t = torch.empty((R,), dtype=torch.float32, device=origin.device)
    out_i = torch.empty((R,), dtype=torch.int32, device=origin.device)
    if R == 0:
        return out_t, out_i
    tensors = [x.contiguous() for x in
               (origin, direction, max_dist, nodes, tris)]
    for x in tensors[3:]:
        if x.data_ptr() % 16:
            raise ValueError("accel tables must be 16-byte aligned")
    lib = load_library()
    stream = torch.cuda.current_stream(origin.device).cuda_stream
    err = getattr(lib, f"dpt_{kernel}")(
        *(ctypes.c_void_p(x.data_ptr()) for x in tensors),
        ctypes.c_int(R), ctypes.c_int(int(occluded)),
        ctypes.c_void_p(out_t.data_ptr()), ctypes.c_void_p(out_i.data_ptr()),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: cudaError {err} "
            f"({lib.dpt_cuda_error_string(err).decode()})")
    return out_t, out_i

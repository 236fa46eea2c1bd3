"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources are compiled by `nvcc` into one shared library with a plain C
interface, loaded with ctypes; nothing includes PyTorch's headers, so a
build takes seconds.  The library goes to `dpt_tpu_torch/_build/` under a
name keyed by a hash of the sources and flags, so an edited source is never
served a stale build.  Nothing here runs at import: the package is also
imported where there is no `nvcc`, and a build happens only when a CUDA
tensor reaches a kernel wrapper.

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

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

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


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the keyed library unless it exists."""
    global build_seconds
    out = library_path()
    build_seconds = 0.0
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in _sources() if p.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
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
    lib.dpt_quad_traverse.argtypes = [p, p, p, p, p, i, i, p, p, p]
    lib.dpt_quad_traverse.restype = i
    lib.dpt_quad_traverse_attrs.argtypes = [
        i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.dpt_quad_traverse_attrs.restype = i
    lib.dpt_cuda_error_string.argtypes = [i]
    lib.dpt_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def kernel_attributes(occluded: bool) -> dict:
    """Registers and local bytes per thread of K1 in one mode."""
    lib = load_library()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.dpt_quad_traverse_attrs(int(occluded), ctypes.byref(regs),
                                      ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return {"num_regs": regs.value, "local_bytes": local.value}

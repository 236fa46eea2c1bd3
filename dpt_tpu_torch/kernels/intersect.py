"""Brute-force nearest hit over every triangle (kernel K3).

Counterpart of `dpt_tpu/kernels/pallas_intersect.py`
(`traversal="brute", kernels="intersect"`): for box-scale scenes (tens to
thousands of triangles) a hierarchy is pure overhead, so every ray is tested
against every triangle.

  - `pack_tris` builds the TPU kernel's table with torch ops on the
    corners' device, byte for byte: ceil(T/8) rows of 128 floats, 8
    triangles x 16 lanes (v0, e1 = v1 - v0, e2 = v2 - v0, oid as float,
    valid), the layout of the BVH walks' leaf rows.
  - `intersect_nearest` launches the hand-written CUDA kernel
    (csrc/intersect_nearest.cu) for CUDA tensors and runs the plain PyTorch
    version (`intersect_nearest_reference`) for CPU tensors.  There is no
    fallback between the two: a CUDA tensor launches the kernel or raises.

Both run the walks' Möller–Trumbore leaf test (quad.py `_leaf_tests`,
traverse_common.cuh `leaf_row`) with the caller's `eps`, in the TPU
kernel's arithmetic order, and keep the first strictly smaller t in slot
order, so ties go to the lowest triangle id; a miss gives t = 1e30 and
tri 0.  The kernel is built with `-fmad=false`, so on the card the two
agree exactly.
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.kernels.quad import T_MAX, _leaf_tests

# An oid stored as float32 is exact only below 2**24.
MAX_TRIS = 1 << 24
# The plain version tests at most about this many (ray, slot) pairs at once:
# its temporaries are [rays, slots] tensors.
_CHUNK_ELEMS = 1 << 24

# Kernel launches.  The wrapper adds one where it launches the CUDA kernel
# and nowhere else; the plain version does not count.
launch_counts = {"nearest": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def pack_tris(v0, v1, v2) -> torch.Tensor:
    """[T, 3] triangle corners -> the [ceil(T/8), 128] float32 table, on
    the corners' device (pallas_intersect.py:26-39)."""
    T = v0.shape[0]
    if T >= MAX_TRIS:
        raise ValueError(f"{T} triangles: the table stores triangle ids as "
                         f"float32, exact only below {MAX_TRIS}")
    v0, v1, v2 = (v.detach() for v in (v0, v1, v2))
    rows = -(-T // 8)
    flat = torch.zeros((rows * 8, 16), dtype=torch.float32, device=v0.device)
    flat[:T, 0:3] = v0
    flat[:T, 3:6] = v1 - v0
    flat[:T, 6:9] = v2 - v0
    flat[:T, 9] = torch.arange(T, dtype=torch.float32, device=v0.device)
    flat[:T, 10] = 1.0
    return flat.reshape(rows, 128)


def intersect_nearest_reference(origin, direction, tris, eps=1e-6):
    """Plain PyTorch nearest hit over every slot of `tris`: (hit [R] bool,
    t [R] f32, tri [R] int32), in chunks of rays."""
    R = origin.shape[0]
    dev = origin.device
    t = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    tri = torch.zeros((R,), dtype=torch.int32, device=dev)
    slots = tris.reshape(1, -1, 16)
    S = slots.shape[1]
    step = max(1, _CHUNK_ELEMS // max(S, 1))
    for a in range(0, R if S else 0, step):
        hit, ts, oid = _leaf_tests(origin[a:a + step], direction[a:a + step],
                                   slots, eps)
        tm = torch.where(hit, ts, torch.full_like(ts, float("inf")))
        # argmin returns the first minimum: the kernel's strict t < best_t
        # in slot order.
        k = torch.argmin(tm, dim=1)
        m = tm.gather(1, k[:, None])[:, 0]
        found = m < T_MAX
        t[a:a + step] = torch.where(found, m, t[a:a + step])
        tri[a:a + step] = torch.where(found, oid[0, k], tri[a:a + step])
    return t < T_MAX, t, tri


def _check_inputs(origin, direction, tris):
    from dpt_tpu_torch.kernels.build import check_rays

    check_rays(origin, direction)
    if tris.dtype != torch.float32:
        raise TypeError(f"tris must be float32, got {tris.dtype}")
    if tris.device != origin.device:
        raise ValueError(f"tris is on {tris.device}, rays on {origin.device}")
    if tris.dim() != 2 or tris.shape[1] != 128:
        raise ValueError("tris must have shape [rows, 128] (pack_tris)")
    if tris.shape[0] * 8 > MAX_TRIS:
        raise ValueError(f"tris holds more than {MAX_TRIS} slots")


def _launch(origin, direction, tris, eps):
    """Launch K3 on the current stream: (t [R] f32, tri [R] int32)."""
    from dpt_tpu_torch.kernels.build import launch_intersect

    out = launch_intersect(origin, direction, tris, float(eps))
    if origin.shape[0]:
        launch_counts["nearest"] += 1
    return out


def intersect_nearest(origin, direction, tris, eps=1e-6):
    """Nearest hit over every triangle of `tris` (pack_tris): (hit [R]
    bool, t [R] f32, tri [R] int32; t 1e30 and tri 0 on a miss).  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    _check_inputs(origin, direction, tris)
    if origin.is_cuda:
        # The kernel leaves tri at 0 where nothing was hit.
        t, tri = _launch(origin, direction, tris, eps)
        return t < T_MAX, t, tri
    if origin.device.type != "cpu":
        raise ValueError(f"intersect: unsupported device {origin.device}")
    return intersect_nearest_reference(origin, direction, tris, eps)

"""Scene containers: dataclasses of float32 / int32 tensors.

Counterpart of `dpt_tpu/scene/scene.py`.  The JAX package registers these as
pytrees; here they are plain dataclasses whose `.to(device)` moves every
tensor.  Float fields are asserted float32 on construction.

Deviation from the reference kept from the JAX package: per-corner UVs
[T, 3, 2] resolved through the OBJ texcoord indices (the shader indexes the
texcoord array with the vertex index, raytrace_comp.comp:151-153).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def check_dtypes(obj) -> None:
    """Raise unless every float tensor field of `obj` is float32."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            if v.dtype != torch.float32:
                raise TypeError(
                    f"{type(obj).__name__}.{f.name} must be float32, "
                    f"got {v.dtype}"
                )


def tensors(obj):
    """Every tensor of a tensor dataclass, nested dataclasses included."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        elif dataclasses.is_dataclass(v):
            yield from tensors(v)


def to_device(obj, device):
    """Copy of a tensor dataclass with every tensor (and nested tensor
    dataclass) moved to `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or hasattr(v, "to"):
            v = v.to(device)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


# What every entry point says when it is asked for the card and there is
# none (the CLI's `--device` defaults to cuda as the library does).
NO_CUDA = ("no CUDA device is available; pass --device cpu (device='cpu') "
           "to run on the CPU")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and there is no
    card.  Entry points default to "cuda" and never fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return device


def f32(a, device) -> torch.Tensor:
    """float32 tensor copied from an array-like (float64 input is rounded
    once)."""
    return torch.as_tensor(np.array(a, np.float32), device=device)


@dataclasses.dataclass
class Lights:
    """Rectangular area lights, parallel arrays (Light.h:6-12)."""

    position: torch.Tensor  # [L, 3]
    normal: torch.Tensor  # [L, 3], normalised (Light.cpp:28)
    intensity: torch.Tensor  # [L, 3]
    size: torch.Tensor  # [L, 2] width, height

    def __post_init__(self):
        check_dtypes(self)

    @property
    def count(self) -> int:
        return self.position.shape[0]

    def to(self, device) -> "Lights":
        return to_device(self, device)


@dataclasses.dataclass
class Materials:
    """Per-material shading parameters; the default material reproduces the
    reference constants (albedo 0.8 at raytrace_comp.comp:341, SSS albedo
    (1, .2, .1) and radius 1.0 at :371-373)."""

    albedo: torch.Tensor  # [M, 3]
    roughness: torch.Tensor  # [M]
    emission: torch.Tensor  # [M, 3]
    sss_albedo: torch.Tensor  # [M, 3]
    sss_radius: torch.Tensor  # [M]

    def __post_init__(self):
        check_dtypes(self)

    def to(self, device) -> "Materials":
        return to_device(self, device)

    @staticmethod
    def default(n: int = 1, device="cuda") -> "Materials":
        # roughness is the Oren–Nayar sigma (render/shading.py); 0 = Lambert.
        device = resolve_device(device)
        return Materials(
            albedo=torch.full((n, 3), 0.8, dtype=torch.float32, device=device),
            roughness=torch.zeros((n,), dtype=torch.float32, device=device),
            emission=torch.zeros((n, 3), dtype=torch.float32, device=device),
            sss_albedo=f32([[1.0, 0.2, 0.1]], device).repeat(n, 1),
            sss_radius=torch.full((n,), 1.0, dtype=torch.float32,
                                  device=device),
        )


@dataclasses.dataclass
class Scene:
    vertices: torch.Tensor  # [V, 3] float32
    indices: torch.Tensor  # [T, 3] int32 (static topology)
    uvs: torch.Tensor  # [T, 3, 2] float32 per-corner texcoords
    mat_idx: torch.Tensor  # [T] int32
    materials: Materials
    lights: Lights

    def __post_init__(self):
        check_dtypes(self)
        for name in ("indices", "mat_idx"):
            if getattr(self, name).dtype != torch.int32:
                raise TypeError(f"Scene.{name} must be int32")

    @property
    def n_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def to(self, device) -> "Scene":
        return to_device(self, device)

    def tri_vertices(self):
        """Gathered triangle corners (v0, v1, v2), each [T, 3]."""
        idx = self.indices
        return (
            self.vertices[idx[:, 0]],
            self.vertices[idx[:, 1]],
            self.vertices[idx[:, 2]],
        )


def make_area_lights(positions, normals, intensities, sizes,
                     device="cuda") -> Lights:
    """Pack parallel lists into Lights (Light.cpp:16-33); normals are
    normalised on pack, as in Light.cpp:28."""
    device = resolve_device(device)
    normals = np.asarray(normals, np.float32)
    normals = normals / np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20
    )
    return Lights(
        position=f32(positions, device),
        normal=f32(normals, device),
        intensity=f32(intensities, device),
        size=f32(sizes, device),
    )


def default_lights(device="cuda") -> Lights:
    """The reference's single hardcoded area light (VulkanRayTracer.cpp:
    149-162): position (0, 2, 0), normal (0, -1, 0), intensity (10, 10, 10),
    size 2.5x2.5."""
    return make_area_lights(
        positions=[[0.0, 2.0, 0.0]],
        normals=[[0.0, -1.0, 0.0]],
        intensities=[[10.0, 10.0, 10.0]],
        sizes=[[2.5, 2.5]],
        device=device,
    )

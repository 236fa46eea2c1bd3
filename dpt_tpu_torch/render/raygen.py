"""Per-pixel camera ray generation with thin-lens DoF and Gaussian AA.

Counterpart of `dpt_tpu/render/raygen.py` (raytrace_comp.comp:420-464): NDC
from pixel coords, per-pixel counter seed, Gaussian aperture offset,
Gaussian sub-pixel jitter, direction through the focal point.

Fixed draw schedule: the four jitter uniforms are always drawn (even with DoF
disabled) so RNG streams are identical across feature configurations.
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.rng import seed_pixels
from dpt_tpu_torch.render.sampling import normalize, random_gaussian


def pixel_grid(cfg: RenderConfig, device):
    """Flattened pixel coordinates px, py [R] int64 (row-major, y down)."""
    py, px = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.int64, device=device),
        torch.arange(cfg.width, dtype=torch.int64, device=device),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def generate_rays(camera, cfg: RenderConfig, sample_batch, px=None, py=None):
    """Returns (origin [R,3] f32, direction [R,3] f32, rng_state [R] int64).

    Rays are made on the camera's device."""
    if px is None:
        px, py = pixel_grid(cfg, camera.device)
    state = seed_pixels(sample_batch, px, py, cfg.width, cfg.height)

    ndc_x = 2.0 * px.to(torch.float32) / cfg.width - 1.0
    ndc_y = 2.0 * py.to(torch.float32) / cfg.height - 1.0
    aspect = cfg.width / cfg.height

    cam_dir = normalize(camera.direction)
    # right/up frame: right = normalize(dir × -up), up' = normalize(right × dir)
    # (raytrace_comp.comp:446-447).
    right = normalize(torch.linalg.cross(cam_dir, -camera.up, dim=-1))
    up = normalize(torch.linalg.cross(right, cam_dir, dim=-1))

    # Aperture offset draw (always consumed; applied only with DoF on).
    state, dof_g = random_gaussian(state)
    origin = camera.position + (
        right * dof_g[:, 0:1] + up * dof_g[:, 1:2]
    ) * (cfg.aperture if cfg.enable_dof else 0.0)

    # AA jitter draw.
    state, aa_g = random_gaussian(state)
    ndc_x = ndc_x + aa_g[:, 0] * cfg.aa_jitter / cfg.width
    ndc_y = ndc_y + aa_g[:, 1] * cfg.aa_jitter / cfg.height

    tan_fov = torch.tan(torch.deg2rad(camera.fov_deg * 0.5))
    base_dir = normalize(
        cam_dir
        + (ndc_x * tan_fov * aspect)[:, None] * (-right)
        - (ndc_y * tan_fov)[:, None] * up
    )
    if cfg.enable_dof:
        focal_point = camera.position + base_dir * cfg.focal_distance
        direction = normalize(focal_point - origin)
    else:
        direction = base_dir
    return origin, direction, state

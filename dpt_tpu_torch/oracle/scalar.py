"""Oracle renderer: slow, trusted, scalar Python path tracer.

A copy of `dpt_tpu/oracle/scalar.py`, with the same pure-Python float
arithmetic in the same order, so both oracles give the same image bit for
bit.  It is an *independent* implementation of the same rendering semantics
as dpt_tpu_torch.render: explicit per-pixel loops, brute-force
intersection, no torch arithmetic.  Tests and `chip_smoke.py` assert that
the vectorised renderer (on the CPU and on the card) matches this oracle
pixel by pixel.

The one change from the JAX file: the scene and camera are read to the
host once, in `OracleScene.__init__` and `render_oracle` (tensors on any
device, or array-likes), and `generate_ray` takes that host camera; the JAX
file reads the camera through `np.asarray` at every pixel, which on a
CUDA tensor would be a device-to-host copy per pixel (and fails).

It shares only the *conventions* with the fast path:
  - the reference's uint32 RNG (raytrace_comp.comp:209-216), here in python
    ints masked to 32 bits;
  - the fixed draw schedule (every pixel-sample consumes the same number of
    draws regardless of path outcome — lanes in the fast path are masked, so
    the oracle must "waste" draws identically);
  - the fixed-hit gradient detach (irrelevant here — forward only; finite
    differences of this oracle validate the fast path's gradients).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dpt_tpu_torch.render.shading import (
    checker_albedo_s,
    interpolate_uv_s,
    oren_nayar_factor_s,
)

M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# RNG (independent scalar port of raytrace_comp.comp:209-216)
# --------------------------------------------------------------------------
def rng_next(state: int):
    state = (state * 747796405 + 2891336453) & M32
    shift = ((state >> 28) + 4) & 31
    word = (((state >> shift) ^ state) * 277803737) & M32
    word = ((word >> 22) ^ word) & M32
    return state, float(word) / 4294967295.0


def seed_pixel(sample_batch: int, px: int, py: int, w: int, h: int) -> int:
    return ((sample_batch * h + py) * w + px) & M32


# --------------------------------------------------------------------------
# small vector helpers (tuples of floats)
# --------------------------------------------------------------------------
def v_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v_mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def v_norm(a):
    return math.sqrt(v_dot(a, a))


def v_normalize(a):
    n = v_norm(a)
    return v_scale(a, 1.0 / n) if n > 1e-20 else a


# --------------------------------------------------------------------------
# sampling (independent ports; same draw order as dpt_tpu.render.sampling)
# --------------------------------------------------------------------------
def random_gaussian(state):
    state, u1 = rng_next(state)
    state, u2 = rng_next(state)
    u1 = max(1e-38, u1)
    r = math.sqrt(-2.0 * math.log(u1))
    th = 2.0 * math.pi * u2
    return state, (r * math.cos(th), r * math.sin(th))


def sample_hemisphere(normal, state):
    state, r1 = rng_next(state)
    state, r2 = rng_next(state)
    theta = math.acos(math.sqrt(max(0.0, min(1.0, 1.0 - r1))))
    phi = 2.0 * math.pi * r2
    st = math.sin(theta)
    local = (st * math.cos(phi), st * math.sin(phi), math.cos(theta))
    up = (0.0, 0.0, 1.0) if abs(normal[2]) < 0.999 else (1.0, 0.0, 0.0)
    tangent = v_normalize(v_cross(up, normal))
    bitangent = v_cross(normal, tangent)
    d = v_add(
        v_add(v_scale(tangent, local[0]), v_scale(bitangent, local[1])),
        v_scale(normal, local[2]),
    )
    return state, d


def sample_sphere(state):
    state, u1 = rng_next(state)
    state, u2 = rng_next(state)
    z = 2.0 * u1 - 1.0
    th = 2.0 * math.pi * u2
    r = math.sqrt(max(0.0, 1.0 - z * z))
    return state, (r * math.cos(th), r * math.sin(th), z)


def light_basis(n):
    basis = (0.0, 1.0, 0.0) if abs(n[1]) < 0.999 else (1.0, 0.0, 0.0)
    right = v_normalize(v_cross(n, basis))
    up = v_cross(right, n)
    return right, up


def sample_area_light(lpos, lnormal, lsize, state):
    state, u = rng_next(state)
    state, v = rng_next(state)
    u = u * 2.0 - 1.0
    v = v * 2.0 - 1.0
    right, up = light_basis(lnormal)
    p = v_add(
        lpos,
        v_add(
            v_scale(right, u * lsize[0] * 0.5), v_scale(up, v * lsize[1] * 0.5)
        ),
    )
    return state, p


def intersect_area_light(o, d, lpos, lnormal, lsize):
    denom = v_dot(lnormal, d)
    if abs(denom) < 1e-4:
        return False, 0.0
    t = v_dot(lnormal, v_sub(lpos, o)) / denom
    if t <= 0.0:
        return False, 0.0
    hp = v_add(o, v_scale(d, t))
    right, up = light_basis(lnormal)
    to_hit = v_sub(hp, lpos)
    u = v_dot(to_hit, right)
    v = v_dot(to_hit, up)
    return (abs(u) <= lsize[0] * 0.5 and abs(v) <= lsize[1] * 0.5), t


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------
def moller_trumbore(o, d, v0, v1, v2, eps=1e-6):
    e1 = v_sub(v1, v0)
    e2 = v_sub(v2, v0)
    p = v_cross(d, e2)
    det = v_dot(e1, p)
    if abs(det) < eps:
        return False, 0.0, 0.0, 0.0
    inv = 1.0 / det
    tv = v_sub(o, v0)
    u = inv * v_dot(tv, p)
    if u < 0.0 or u > 1.0:
        return False, 0.0, 0.0, 0.0
    q = v_cross(tv, e1)
    v = inv * v_dot(d, q)
    if v < 0.0 or u + v > 1.0:
        return False, 0.0, 0.0, 0.0
    t = inv * v_dot(e2, q)
    if t <= eps:
        return False, 0.0, 0.0, 0.0
    return True, t, u, v


def _host(a, dtype=None) -> np.ndarray:
    """A tensor on any device, or an array-like, as a host numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class HostCamera:
    """The camera as python floats: what `generate_ray` reads."""

    position: tuple
    direction: tuple
    up: tuple
    fov_deg: float


def host_camera(camera) -> HostCamera:
    """Read a Camera (tensors on any device) to the host once."""
    return HostCamera(
        position=tuple(float(x) for x in _host(camera.position)),
        direction=tuple(float(x) for x in _host(camera.direction)),
        up=tuple(float(x) for x in _host(camera.up)),
        fov_deg=float(_host(camera.fov_deg)),
    )


class OracleScene:
    """Plain-python mirror of dpt_tpu_torch.scene.Scene, read to the host
    once."""

    def __init__(self, scene):
        v = _host(scene.vertices, float)
        idx = _host(scene.indices, int)
        self.tris = [
            (tuple(v[i0]), tuple(v[i1]), tuple(v[i2])) for i0, i1, i2 in idx
        ]
        self.mat_idx = [int(m) for m in _host(scene.mat_idx)]
        uv = _host(scene.uvs, float)  # [T, 3, 2]
        self.uvs = [
            tuple(tuple(c) for c in corners) for corners in uv
        ]
        m = scene.materials
        self.albedo = [tuple(a) for a in _host(m.albedo, float)]
        self.roughness = [float(r) for r in _host(m.roughness)]
        self.emission = [tuple(a) for a in _host(m.emission, float)]
        self.sss_albedo = [
            tuple(a) for a in _host(m.sss_albedo, float)
        ]
        self.sss_radius = [float(a) for a in _host(m.sss_radius)]
        l = scene.lights
        self.lights = [
            {
                "pos": tuple(p),
                "normal": tuple(n),
                "intensity": tuple(i),
                "size": tuple(s),
            }
            for p, n, i, s in zip(
                *(
                    _host(x, float)
                    for x in (l.position, l.normal, l.intensity, l.size)
                )
            )
        ]

    def nearest(self, o, d, eps=1e-6):
        best_t, best_tri = 1e30, -1
        best_u = best_v = 0.0
        for i, (v0, v1, v2) in enumerate(self.tris):
            hit, t, u, v = moller_trumbore(o, d, v0, v1, v2, eps)
            if hit and t < best_t:
                best_t, best_tri, best_u, best_v = t, i, u, v
        return best_tri >= 0, best_t, best_tri, best_u, best_v


def trace_path(o, d, state, sc: OracleScene, cfg):
    """Scalar pathTrace with the fixed draw schedule (see module docstring)."""
    radiance = [0.0, 0.0, 0.0]
    throughput = (1.0, 1.0, 1.0)
    active = True

    # direct-view pass (raytrace_comp.comp:309-328); no draws
    dv_value = None
    if cfg.direct_light_view:
        prim_hit, prim_t, _, _, _ = sc.nearest(o, d, cfg.eps)
        for lt in sc.lights:
            lhit, t = intersect_area_light(o, d, lt["pos"], lt["normal"], lt["size"])
            if lhit and ((not prim_hit) or prim_t > t):
                dv_value = lt["intensity"]
                break

    for depth in range(cfg.max_depth):
        hit, t, tri, mt_u, mt_v = sc.nearest(o, d, cfg.eps)
        hit = hit and active
        view = (-d[0], -d[1], -d[2])
        if hit:
            v0, v1, v2 = sc.tris[tri]
            pos = v_add(o, v_scale(d, t))
            normal = v_normalize(v_cross(v_sub(v1, v0), v_sub(v2, v0)))
            mat = sc.mat_idx[tri]
            albedo = sc.albedo[mat]
            rough = sc.roughness[mat]
            if cfg.uv_texture == "checker":
                uv = interpolate_uv_s(sc.uvs[tri], mt_u, mt_v)
                albedo = checker_albedo_s(albedo, uv, cfg.uv_texture_scale)
            for k in range(3):
                radiance[k] += throughput[k] * sc.emission[mat][k]
        else:
            pos, normal = (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)
            mat, albedo, rough = 0, sc.albedo[0], sc.roughness[0]

        # NEE (draws 2 per light, unconditionally)
        for lt in sc.lights:
            state, lp = sample_area_light(lt["pos"], lt["normal"], lt["size"], state)
            if hit:
                to_l = v_sub(lp, pos)
                ldist = v_norm(to_l)
                ldir = v_scale(to_l, 1.0 / max(ldist, 1e-20))
                diffuse = max(v_dot(normal, ldir), 0.0)
                if rough != 0.0:
                    diffuse *= oren_nayar_factor_s(normal, ldir, view, rough)
                so = v_add(pos, v_scale(normal, cfg.offset))
                s_hit, s_t, _, _, _ = sc.nearest(so, ldir, cfg.eps)
                if (not s_hit) or s_t >= ldist - cfg.offset:
                    dist_sq = max(ldist * ldist, 0.01)
                    for k in range(3):
                        radiance[k] += (
                            throughput[k]
                            * albedo[k]
                            * lt["intensity"][k]
                            * diffuse
                            / dist_sq
                        )

        # SSS walk (draws: 2 + per bounce (2L + 2), unconditionally)
        if cfg.enable_sss:
            sss_albedo = sc.sss_albedo[mat]
            sss_radius = sc.sss_radius[mat]
            weight = 1.0 + sss_radius * 0.5
            sss_throughput = (1.0, 1.0, 1.0)
            sss_active = hit
            state, sd = sample_sphere(state)
            so_ = v_sub(pos, v_scale(normal, cfg.offset))
            sdir = sd
            for _ in range(cfg.sss_bounces):
                sh_hit, sh_t, sh_tri, _, _ = sc.nearest(so_, sdir, cfg.eps)
                sh = sh_hit and sss_active
                if sh:
                    sv0, sv1, sv2 = sc.tris[sh_tri]
                    sn = v_normalize(v_cross(v_sub(sv1, sv0), v_sub(sv2, sv0)))
                    cur = v_add(so_, v_scale(sdir, sh_t))
                else:
                    sn, cur = (0.0, 0.0, 1.0), (0.0, 0.0, 0.0)
                for lt in sc.lights:
                    state, lp = sample_area_light(
                        lt["pos"], lt["normal"], lt["size"], state
                    )
                    if sh:
                        to_l = v_sub(lp, cur)
                        ldist = v_norm(to_l)
                        ldir = v_scale(to_l, 1.0 / max(ldist, 1e-20))
                        ediff = max(v_dot(sn, ldir), 0.0)
                        eo = v_add(cur, v_scale(sn, cfg.offset))
                        e_hit, e_t, _, _, _ = sc.nearest(eo, ldir, cfg.eps)
                        if (not e_hit) or e_t >= ldist - cfg.offset:
                            dist_sq = max(ldist * ldist, 0.01)
                            for k in range(3):
                                radiance[k] += (
                                    throughput[k]
                                    * sss_throughput[k]
                                    * sss_albedo[k]
                                    * ediff
                                    * lt["intensity"][k]
                                    / dist_sq
                                    * weight
                                )
                if sh:
                    atten = math.exp(-sh_t / max(sss_radius * 1.5, 1e-6))
                    sss_throughput = tuple(
                        sss_throughput[k] * sss_albedo[k] * atten for k in range(3)
                    )
                sss_active = sh
                state, nd = sample_sphere(state)
                if sh:
                    so_ = v_sub(cur, v_scale(sn, cfg.offset))
                sdir = nd

        # indirect bounce (2 draws)
        state, bdir = sample_hemisphere(normal, state)
        if hit:
            cos_b = max(v_dot(normal, bdir), 0.0)
            throughput = tuple(throughput[k] * albedo[k] * cos_b for k in range(3))
            o = v_add(pos, v_scale(normal, cfg.offset))
            d = bdir
        active = hit

        # Russian roulette (1 draw)
        if cfg.russian_roulette:
            state, u = rng_next(state)
            p = max(0.05, min(1.0, max(throughput)))
            if depth >= cfg.rr_start_depth:
                if u < p:
                    throughput = tuple(c / p for c in throughput)
                else:
                    active = False

    if dv_value is not None:
        return dv_value
    return tuple(radiance)


def generate_ray(camera: HostCamera, cfg, sample_batch, px, py):
    """Scalar mirror of render.raygen.generate_rays; `camera` from
    `host_camera`."""
    cam_pos = camera.position
    cam_dir = v_normalize(camera.direction)
    cam_up = camera.up
    fov = camera.fov_deg

    state = seed_pixel(sample_batch, px, py, cfg.width, cfg.height)
    ndc_x = 2.0 * px / cfg.width - 1.0
    ndc_y = 2.0 * py / cfg.height - 1.0
    aspect = cfg.width / cfg.height

    right = v_normalize(v_cross(cam_dir, v_scale(cam_up, -1.0)))
    up = v_normalize(v_cross(right, cam_dir))

    state, dof = random_gaussian(state)
    ap = cfg.aperture if cfg.enable_dof else 0.0
    origin = v_add(
        cam_pos, v_add(v_scale(right, dof[0] * ap), v_scale(up, dof[1] * ap))
    )
    state, aa = random_gaussian(state)
    ndc_x += aa[0] * cfg.aa_jitter / cfg.width
    ndc_y += aa[1] * cfg.aa_jitter / cfg.height

    tan_fov = math.tan(math.radians(fov * 0.5))
    base = v_normalize(
        v_add(
            cam_dir,
            v_add(
                v_scale(right, -(ndc_x * tan_fov * aspect)),
                v_scale(up, -(ndc_y * tan_fov)),
            ),
        )
    )
    if cfg.enable_dof:
        focal = v_add(cam_pos, v_scale(base, cfg.focal_distance))
        direction = v_normalize(v_sub(focal, origin))
    else:
        direction = base
    return origin, direction, state


def render_oracle(scene, camera, cfg, sample_batch: int = 0, spp=None):
    """Full-frame oracle render → numpy [H, W, 3] float64."""
    sc = OracleScene(scene)
    cam = host_camera(camera)
    n_spp = cfg.spp if spp is None else spp
    img = np.zeros((cfg.height, cfg.width, 3), float)
    for py in range(cfg.height):
        for px in range(cfg.width):
            acc = [0.0, 0.0, 0.0]
            for s in range(n_spp):
                sb = sample_batch * n_spp + s
                o, d, state = generate_ray(cam, cfg, sb, px, py)
                c = trace_path(o, d, state, sc, cfg)
                for k in range(3):
                    acc[k] += c[k]
            img[py, px] = [a / n_spp for a in acc]
    return img

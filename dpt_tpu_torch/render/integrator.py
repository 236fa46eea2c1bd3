"""The path-tracing integrator, forward only.

Counterpart of `dpt_tpu/render/integrator.py` without the query tape:
every lane advances in lockstep through the bounces with an `active` mask
and consumes an identical RNG draw schedule.  The JAX `lax.scan` over
bounces is a Python loop here.

Stages per bounce (reference cites, raytrace_comp.comp):
  - nearest-hit search                (traceRay, :159-204)
  - re-intersection of the hit        (intersect.reintersect)
  - NEE against every area light      (:341-367)
  - subsurface random walk            (:370-408)
  - cosine-weighted indirect bounce   (:411-414)
  - Russian roulette                  (absent in the reference)
plus the direct-view light pass before the loop (:309-328), which shares
the one primary trace with bounce 0.

Carry compaction (cfg.compact_frac > 0): after the primary trace the bounce
loop runs only on the lanes whose primary ray hit — exactly `n_live` lanes,
gathered in Morton order of the hit position by one stable argsort, and
scattered back over zeros.  Every lane that misses at bounce 0 contributes
exactly zero from the whole loop, so this is exact per lane.  (The JAX
package compacts into a static capacity with chunked overflow, because XLA
needs static shapes; PyTorch does not.)
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.intersect import reintersect
from dpt_tpu_torch.render.rng import MASK32, rng_next
from dpt_tpu_torch.render.sampling import (
    intersect_area_light,
    sample_area_light,
    sample_hemisphere,
    sample_sphere,
    vec3,
)
from dpt_tpu_torch.render.shading import checker_albedo, oren_nayar_factor

_FAR = 1e9
_UP_Z = [0.0, 0.0, 1.0]


def _masked_query(o, d, active):
    """Move inactive lanes' origins far outside every AABB (1e9) and pin
    their direction to +z, so every box test misses at once."""
    m = active[:, None]
    o = torch.where(m, o, torch.full_like(o, _FAR))
    d = torch.where(m, d, vec3(_UP_Z, d))
    return o, d


def _safe_hit(rec, hit_mask):
    """Sanitise hit record fields on masked lanes so downstream math never
    sees NaN/Inf."""
    m = hit_mask[:, None]
    return {
        "t": torch.where(hit_mask, rec["t"], torch.ones_like(rec["t"])),
        "position": torch.where(m, rec["position"],
                                torch.zeros_like(rec["position"])),
        "normal": torch.where(m, rec["normal"], vec3(_UP_Z, rec["normal"])),
        "u": rec["u"],
        "v": rec["v"],
    }


def _light(scene, i):
    lt = scene.lights
    return lt.position[i], lt.normal[i], lt.intensity[i], lt.size[i]


def _nee_one_light(state, pos, normal, albedo, light_i, occluded, offset,
                   mask, view=None, rough=None):
    """Direct lighting from one area light (raytrace_comp.comp:345-366).

    Returns (state, contribution [R,3]).  Visibility is an any-hit query;
    masked lanes get max_dist = -1.  With `view`/`rough` the Lambert term
    is scaled by the Oren–Nayar factor.
    """
    lpos, lnormal, lint, lsize = light_i
    state, lpoint = sample_area_light(lpos, lnormal, lsize, state)
    to_light = lpoint - pos
    ldist = torch.linalg.vector_norm(to_light, dim=-1)
    ldir = to_light / torch.clamp(ldist, min=1e-20)[:, None]
    diffuse = torch.clamp((normal * ldir).sum(-1), min=0.0)
    if view is not None and rough is not None:
        diffuse = diffuse * oren_nayar_factor(normal, ldir, view, rough)

    shadow_o = pos + normal * offset
    occ = occluded(shadow_o, ldir,
                   torch.where(mask, ldist - offset,
                               torch.full_like(ldist, -1.0)))

    dist_sq = torch.clamp(ldist * ldist, min=0.01)  # falloff floor, :363
    contrib = albedo * lint * (diffuse / dist_sq)[:, None]
    return state, torch.where(((~occ) & mask)[:, None], contrib,
                              torch.zeros_like(contrib))


def _direct_view_pass(origin, direction, scene, prim):
    """Show a light directly when the primary ray reaches it unoccluded
    (raytrace_comp.comp:309-328); the first qualifying light wins."""
    R = origin.shape[0]
    done = torch.zeros((R,), dtype=torch.bool, device=origin.device)
    value = torch.zeros((R, 3), dtype=torch.float32, device=origin.device)
    for i in range(scene.lights.count):
        lpos, lnormal, lint, lsize = _light(scene, i)
        lhit, lt = intersect_area_light(origin, direction, lpos, lnormal,
                                        lsize)
        visible = lhit & ((~prim["hit"]) | (prim["t"] > lt))
        newly = visible & (~done)
        value = torch.where(newly[:, None], lint.expand_as(value), value)
        done = done | newly
    return done, value


def _sss_walk(state, hit_pos, hit_normal, sss_albedo, sss_radius, throughput,
              hit_mask, scene, nearest, occluded, cfg: RenderConfig):
    """Subsurface random walk (raytrace_comp.comp:370-408).

    Fires cfg.sss_bounces sub-steps below the surface; per step, NEE to every
    light from the interior exit point.  Returns (state, radiance_add).
    """
    R = hit_pos.shape[0]
    radiance_add = torch.zeros((R, 3), dtype=torch.float32,
                               device=hit_pos.device)
    sss_throughput = torch.ones_like(radiance_add)
    sss_active = hit_mask
    state, d0 = sample_sphere(state)
    o = hit_pos - hit_normal * cfg.offset
    d = d0
    inv_atten = (1.0 / torch.clamp(sss_radius * 1.5, min=1e-6))[:, None]
    weight = (1.0 + sss_radius * 0.5)[:, None]  # :404

    for _ in range(cfg.sss_bounces):
        found = nearest(*_masked_query(o, d, sss_active))
        sh = found["hit"] & sss_active
        rec = _safe_hit(
            reintersect(o, d, found["tri"], scene.vertices, scene.indices,
                        cfg.eps),
            sh,
        )
        cur = o + d * rec["t"][:, None]
        sn = rec["normal"]

        sss_light = torch.zeros_like(radiance_add)
        for i in range(scene.lights.count):
            state, c = _nee_one_light(
                state, cur, sn, sss_albedo, _light(scene, i), occluded,
                cfg.offset, sh,
            )
            sss_light = sss_light + c
        radiance_add = (radiance_add
                        + throughput * sss_throughput * sss_light * weight)

        atten = torch.exp(-rec["t"][:, None] * inv_atten)
        sss_throughput = torch.where(
            sh[:, None], sss_throughput * sss_albedo * atten, sss_throughput
        )
        sss_active = sh
        state, nd = sample_sphere(state)
        o = torch.where(sh[:, None], cur - sn * cfg.offset, o)
        d = nd
    return state, radiance_add


def make_bounce_body(scene, nearest, occluded, cfg: RenderConfig):
    """One bounce of the path loop over the carry
    (origin, direction, throughput, radiance, active, rng_state).

    `body(carry, depth, found=None)` accepts a precomputed nearest-hit
    record so bounce 0 can reuse the primary trace."""

    def body(carry, depth, found=None):
        o, d, throughput, radiance, active, state = carry

        if found is None:
            found = nearest(*_masked_query(o, d, active))
        hit = found["hit"] & active
        rec = reintersect(o, d, found["tri"], scene.vertices, scene.indices,
                          cfg.eps,
                          uvs=scene.uvs if cfg.uv_texture != "none" else None)
        uv = rec.get("uv")
        rec = _safe_hit(rec, hit)
        pos, normal = rec["position"], rec["normal"]
        mat = scene.mat_idx[found["tri"].long()].long()
        albedo = scene.materials.albedo[mat]
        emission = scene.materials.emission[mat]
        rough = scene.materials.roughness[mat]
        view = -d  # toward the camera along the incoming ray
        if cfg.uv_texture == "checker":
            albedo = checker_albedo(
                albedo, torch.where(hit[:, None], uv, torch.zeros_like(uv)),
                cfg.uv_texture_scale,
            )

        # Emissive surfaces (zero by default).
        radiance = radiance + torch.where(
            hit[:, None], throughput * emission, torch.zeros_like(radiance)
        )

        # --- next-event estimation over all lights (:341-367) ---
        direct = torch.zeros_like(radiance)
        for i in range(scene.lights.count):
            state, c = _nee_one_light(
                state, pos, normal, albedo, _light(scene, i), occluded,
                cfg.offset, hit, view=view, rough=rough,
            )
            direct = direct + c
        radiance = radiance + throughput * direct

        # --- subsurface walk (:370-408) ---
        if cfg.enable_sss:
            state, sss_add = _sss_walk(
                state, pos, normal,
                scene.materials.sss_albedo[mat],
                scene.materials.sss_radius[mat],
                throughput, hit, scene, nearest, occluded, cfg,
            )
            radiance = radiance + sss_add

        # --- cosine-weighted indirect bounce (:411-414) ---
        state, bdir = sample_hemisphere(normal, state)
        cos_b = torch.clamp((normal * bdir).sum(-1), min=0.0)
        throughput = torch.where(
            hit[:, None], throughput * albedo * cos_b[:, None], throughput
        )
        o = torch.where(hit[:, None], pos + normal * cfg.offset, o)
        d = torch.where(hit[:, None], bdir, d)
        active = hit

        # --- Russian roulette ---
        if cfg.russian_roulette:
            state, u = rng_next(state)
            p = torch.clamp(throughput.max(dim=-1).values, 0.05, 1.0)
            roll = depth >= cfg.rr_start_depth
            survive = (u < p) | (not roll)
            if roll:
                throughput = torch.where(
                    survive[:, None], throughput / p[:, None], throughput)
            active = active & survive

        return (o, d, throughput, radiance, active, state)

    return body


def _run_bounces(body, carry, prim, cfg: RenderConfig):
    """Bounce 0 on the shared primary record, then bounces 1..max_depth-1;
    returns the radiance [R, 3]."""
    carry = body(carry, 0, found=prim)
    for depth in range(1, cfg.max_depth):
        carry = body(carry, depth)
    return carry[3]


def trace_paths(origin, direction, state, scene, nearest, cfg: RenderConfig,
                occluded=None):
    """Full per-sample radiance estimate (pathTrace, :300-418).

    origin/direction: [R, 3] f32; state: [R] int64 RNG.  Returns radiance
    [R, 3].
    """
    R = origin.shape[0]
    if occluded is None:
        def occluded(o, d, max_dist):  # any-hit via the nearest-hit search
            s = nearest(o, d)
            return s["hit"] & (s["t"] < max_dist)

    radiance = torch.zeros_like(origin)
    throughput = torch.ones_like(origin)
    active = torch.ones((R,), dtype=torch.bool, device=origin.device)

    # One primary trace shared by the direct-view pass and bounce 0; the
    # primary stream keeps raster order (no coherence sort).
    prim = getattr(nearest, "unsorted", nearest)(origin, direction)
    if cfg.direct_light_view:
        dv_done, dv_value = _direct_view_pass(origin, direction, scene, prim)
    else:
        dv_done = torch.zeros((R,), dtype=torch.bool, device=origin.device)
        dv_value = radiance

    body = make_bounce_body(scene, nearest, occluded, cfg)
    carry = (origin, direction, throughput, radiance, active, state)

    if cfg.compact_frac > 0:
        from dpt_tpu_torch.render.compaction import morton3d

        hit0 = prim["hit"] & active
        n_live = int(hit0.sum())
        bmin = scene.vertices.min(dim=0).values
        bmax = scene.vertices.max(dim=0).values
        pos_key = origin + prim["t"][:, None] * direction
        key = torch.where(hit0, morton3d(pos_key, bmin, bmax),
                          torch.full_like(hit0, MASK32, dtype=torch.int64))
        perm = torch.argsort(key, stable=True)[:n_live]
        radiance = torch.zeros_like(origin)
        if n_live:
            carry_c = tuple(x.index_select(0, perm) for x in carry)
            prim_c = {k: v.index_select(0, perm) for k, v in prim.items()}
            radiance = radiance.index_copy(
                0, perm, _run_bounces(body, carry_c, prim_c, cfg))
    else:
        radiance = _run_bounces(body, carry, prim, cfg)

    return torch.where(dv_done[:, None], dv_value, radiance)

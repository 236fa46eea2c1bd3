"""The path-tracing integrator: masked, differentiable, with a query tape.

Counterpart of `dpt_tpu/render/integrator.py`: every lane advances in
lockstep through the bounces with an `active` mask and consumes an
identical RNG draw schedule.  The JAX `lax.scan` over bounces is a Python
loop here.

Gradient convention (fixed-hit detach): which triangle is nearest, the
hit/miss masks and shadow visibility are detached; t, barycentrics,
positions, normals and shading are recomputed differentiably for the
selected triangle (intersect.reintersect).

Stages per bounce (reference cites, raytrace_comp.comp):
  - nearest-hit search                (traceRay, :159-204)
  - re-intersection of the hit        (intersect.reintersect)
  - NEE against every area light      (:341-367)
  - subsurface random walk            (:370-408)
  - cosine-weighted indirect bounce   (:411-414)
  - Russian roulette                  (absent in the reference)
plus the direct-view light pass before the loop (:309-328), which shares
the one primary trace with bounce 0.

Carry compaction (cfg.compact_frac), as in the JAX package: after the
primary trace the lanes are ordered live first, in Morton order of the hit
position (one stable argsort), padded with the index R up to k = ceil(R/C)
chunks of the static capacity C = ceil(compact_frac * R / 128) * 128
(`capacity`; compaction applies when 0 < C < R).  Each chunk gathers its C
lanes, runs bounce 0's shade phase and the bounce loop at width C, and its
radiance is scattered back over zeros (the pad index R lands in a row that
is dropped).  Every lane that misses at bounce 0 contributes exactly zero
from the whole loop, so this is exact per lane at any capacity.  Chunk 0
always runs; chunk c > 0 runs only when it holds live lanes (n_live >
c * C).  The live-lane count reaches the host without a stream sync
(`_HostCount`: a non_blocking copy to pinned memory and an event), and the
host reads it only after chunk 0 is queued, so it waits for the primary
trace alone and never for work queued after it.

Query tape: since every traversal outcome is detached, a render is a
deterministic function of (params, seed) and of those outcomes.
`trace_paths(..., tape="record")` also returns every outcome (a nearest
query as one int32 per lane, the triangle or -1, plus `t` for the primary;
an occluded query as its bool), one list of bounces per chunk that ran
(`chunks`, or `body` without compaction), and `trace_paths(..., tape=<that
tape>)` plays the render back without a single traversal or per-query
sort.  The playback recomputes n_live and the compaction permutation from
the taped primary (`hit`, `t`), so it runs the recording's chunks on the
same lanes in the same order.

Wavefront sort (cfg.wavefront_sort): in every bounce, after its nearest
query and before the NEE / SSS / bounce-direction phase, the whole carry
is permuted once by the Morton code of the hit position (misses last; one
stable argsort), and scattered back to carry order after the bounce.  The
seven queries of the phase leave the hit position, so one permutation
serves all of them, and the per-query coherence sort is off.  A pure
permutation of lanes: the image is the unsorted render's bit for bit.  The
tape records each bounce's nearest `t` as well, so a playback sorts by the
same keys.
"""

from __future__ import annotations

import torch

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.intersect import reintersect, rows
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


class QueryTape:
    """Record or substitute the detached outcome of every nearest/occluded
    call, in call order.

    mode "off"    — pass through (the plain render).
    mode "record" — call the real query and append its outcome.
    mode "play"   — never call the query; return the next recorded outcome.

    A nearest outcome is stored as one int32 per lane (the triangle where
    hit, else -1); playback decodes a miss to tri 0, which every consumer
    masks, and carries t = 0, which reintersect re-derives.  A call with
    with_t=True (the wavefront sort's key reads t) stores {"tri1", "t"}
    and plays t back.  The primary trace, whose `t` the compaction needs,
    is taped by `trace_paths`.
    """

    def __init__(self, mode: str, entries=None):
        if mode not in ("off", "record", "play"):
            raise ValueError(f"unknown tape mode {mode!r}")
        self.mode = mode
        self.entries = list(entries) if entries is not None else []
        self._i = 0

    def _next(self):
        e = self.entries[self._i]
        self._i += 1
        return e

    def nearest(self, fn, o, d, with_t: bool = False):
        if self.mode == "play":
            e = self._next()
            tri1 = e["tri1"] if with_t else e
            t = e["t"] if with_t else torch.zeros(
                tri1.shape, dtype=torch.float32, device=tri1.device)
            return {"hit": tri1 >= 0, "tri": tri1.clamp(min=0), "t": t}
        rec = fn(o, d)
        if self.mode == "record":
            tri1 = _tri_or_miss(rec)
            self.entries.append({"tri1": tri1, "t": rec["t"]} if with_t
                                else tri1)
        return rec

    def occluded(self, fn, o, d, max_dist):
        if self.mode == "play":
            return self._next()
        occ = fn(o, d, max_dist)
        if self.mode == "record":
            self.entries.append(occ)
        return occ


_TAPE_OFF = QueryTape("off")


def _tri_or_miss(rec):
    """A nearest record's taped form: the triangle where hit, else -1."""
    return torch.where(rec["hit"], rec["tri"], torch.full_like(rec["tri"], -1))


def _masked_query(o, d, active):
    """Move inactive lanes' origins far outside every AABB (1e9) and pin
    their direction to +z, so every box test misses at once.  The query
    inputs are detached: the search only selects."""
    m = active[:, None]
    o = torch.where(m, o.detach(), torch.full_like(o, _FAR))
    d = torch.where(m, d.detach(), vec3(_UP_Z, d))
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
                   mask, view=None, rough=None, tio=_TAPE_OFF):
    """Direct lighting from one area light (raytrace_comp.comp:345-366).

    Returns (state, contribution [R,3]).  Visibility is a detached any-hit
    query; masked lanes get max_dist = -1.  With `view`/`rough` the Lambert
    term is scaled by the Oren–Nayar factor.
    """
    lpos, lnormal, lint, lsize = light_i
    state, lpoint = sample_area_light(lpos, lnormal, lsize, state)
    to_light = lpoint - pos
    ldist = torch.linalg.vector_norm(to_light, dim=-1)
    ldir = to_light / torch.clamp(ldist, min=1e-20)[:, None]
    diffuse = torch.clamp((normal * ldir).sum(-1), min=0.0)
    if view is not None and rough is not None:
        diffuse = diffuse * oren_nayar_factor(normal, ldir, view, rough)

    shadow_o = (pos + normal * offset).detach()
    occ = tio.occluded(occluded, shadow_o, ldir.detach(),
                       torch.where(mask, ldist.detach() - offset,
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
              hit_mask, scene, nearest, occluded, cfg: RenderConfig,
              tio=_TAPE_OFF):
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
        found = tio.nearest(nearest, *_masked_query(o, d, sss_active))
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
                cfg.offset, sh, tio=tio,
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

    `body(carry, depth, found=None, tio=...)` accepts a precomputed
    nearest-hit record so bounce 0 can reuse the primary trace, and a
    QueryTape that records or substitutes every query."""

    def body(carry, depth, found=None, tio=_TAPE_OFF):
        o, d, throughput, radiance, active, state = carry

        if found is None:
            found = tio.nearest(nearest, *_masked_query(o, d, active))
        hit = found["hit"] & active
        rec = reintersect(o, d, found["tri"], scene.vertices, scene.indices,
                          cfg.eps,
                          uvs=scene.uvs if cfg.uv_texture != "none" else None)
        uv = rec.get("uv")
        rec = _safe_hit(rec, hit)
        pos, normal = rec["position"], rec["normal"]
        mat = scene.mat_idx[found["tri"].long()].long()
        albedo = rows(scene.materials.albedo, mat)
        emission = rows(scene.materials.emission, mat)
        rough = rows(scene.materials.roughness, mat)
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
                cfg.offset, hit, view=view, rough=rough, tio=tio,
            )
            direct = direct + c
        radiance = radiance + throughput * direct

        # --- subsurface walk (:370-408) ---
        if cfg.enable_sss:
            state, sss_add = _sss_walk(
                state, pos, normal,
                rows(scene.materials.sss_albedo, mat),
                rows(scene.materials.sss_radius, mat),
                throughput, hit, scene, nearest, occluded, cfg, tio=tio,
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


def _wavefront_sorted(body, nearest, scene):
    """`body` with the carry-level wavefront sort around its shade phase
    (module docstring): the bounce's nearest query in carry order, one
    stable argsort of the hit positions' Morton codes (misses last), the
    body on the permuted carry, and a scatter back to carry order."""
    from dpt_tpu_torch.render.compaction import morton3d

    verts = scene.vertices.detach()
    bmin, bmax = verts.min(dim=0).values, verts.max(dim=0).values

    def stage(carry, depth, found=None, tio=_TAPE_OFF):
        o, d, _, _, active, _ = carry
        if found is None:
            found = tio.nearest(nearest, *_masked_query(o, d, active),
                                with_t=True)
        hit = found["hit"] & active
        pos = o.detach() + found["t"][:, None] * d.detach()
        key = torch.where(hit, morton3d(pos, bmin, bmax),
                          torch.full_like(hit, MASK32, dtype=torch.int64))
        q = torch.argsort(key, stable=True)
        inner = tuple(x.index_select(0, q) for x in carry)
        found_q = {k: v.index_select(0, q) for k, v in found.items()}
        out = body(inner, depth, found=found_q, tio=tio)
        # A pure permutation scatter: carry order exactly, gradients
        # through the gather and the scatter.
        return tuple(torch.zeros_like(x).index_copy(0, q, x) for x in out)

    return stage


def _checkpointed(fn, *args):
    """fn(*args) under torch.utils.checkpoint when autograd records: the
    backward recomputes it instead of keeping its activations.  The RNG is
    a counter in the carry, so the recomputation is exact."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _run_bounces(body, carry, prim, cfg: RenderConfig, mode: str,
                 tape_bounces=None):
    """Bounce 0 on the shared primary record, then bounces 1..max_depth-1.

    mode "off" and "play" return the radiance [R, 3] (remat per bounce
    under cfg.remat_bounces); "record" returns (radiance, [entries of each
    bounce]).  `tape_bounces` holds those entries for "play"."""
    recorded = []

    def step(depth, found, entries, *c):
        tio = QueryTape(mode, entries)
        out = body(c, depth, found=found, tio=tio)
        if mode == "record":
            recorded.append(tuple(tio.entries))
        return out

    for depth in range(cfg.max_depth):
        found = prim if depth == 0 else None
        entries = tape_bounces[depth] if mode == "play" else None
        if mode != "record" and cfg.remat_bounces:
            carry = _checkpointed(
                lambda *c, d=depth, f=found, e=entries: step(d, f, e, *c),
                *carry)
        else:
            carry = step(depth, found, entries, *carry)
    if mode == "record":
        return carry[3], recorded
    return carry[3]


def capacity(R: int, compact_frac: float) -> int:
    """The JAX package's static capacity: ceil(R * compact_frac / 128) * 128
    lanes (0 with compaction off).  Compaction applies when 0 < C < R."""
    return int(-(-(R * compact_frac) // 128) * 128) if compact_frac else 0


class _HostCount:
    """A count on the device, read on the host without a stream sync: it is
    copied (non_blocking) into pinned memory and an event is recorded after
    the copy; reading the value waits on that event only, so the host never
    waits for work queued after the count.  On the CPU it is the count."""

    def __init__(self, n):
        self._ready = None
        if n.device.type == "cuda":
            self._host = torch.empty((), dtype=n.dtype, pin_memory=True)
            self._host.copy_(n, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(n.device))
        else:
            self._host = n
        self._value = None

    def value(self) -> int:
        if self._value is None:
            if self._ready is not None:
                self._ready.synchronize()
            self._value = int(self._host)
        return self._value


def _compaction_order(prim, origin, direction, scene, C: int):
    """(perm [k*C], n_live): the lanes in Morton order of the primary hit
    position, live lanes first (one stable argsort), padded with the index
    R up to k = ceil(R / C) chunks of C; and the live-lane count as a
    _HostCount.  A playback calls it on the taped primary (hit, t) and so
    gets the recording's lanes, order and chunk decisions."""
    from dpt_tpu_torch.render.compaction import morton3d

    hit0 = prim["hit"]
    R = hit0.shape[0]
    verts = scene.vertices.detach()
    pos_key = origin.detach() + prim["t"][:, None] * direction.detach()
    key = torch.where(hit0, morton3d(pos_key, verts.min(dim=0).values,
                                     verts.max(dim=0).values),
                      torch.full_like(hit0, MASK32, dtype=torch.int64))
    perm = torch.argsort(key, stable=True)
    pad = -(-R // C) * C - R
    if pad:
        perm = torch.cat([perm, perm.new_full((pad,), R)])
    return perm, _HostCount(hit0.sum())


def _chunk(carry, prim, idx, R: int, padded: bool):
    """The carry and primary record of the lanes `idx` (one chunk).  With
    `padded` (the last chunk holds pad entries, index R) a pad entry
    gathers lane R - 1 as an inactive lane, so it does no work, and the
    scatter drops its result."""
    gidx = idx.clamp(max=R - 1) if padded else idx
    carry_c = [x.index_select(0, gidx) for x in carry]
    if padded:
        carry_c[4] = carry_c[4] & (idx < R)
    return tuple(carry_c), {k: v.index_select(0, gidx)
                            for k, v in prim.items()}


def trace_paths(origin, direction, state, scene, nearest, cfg: RenderConfig,
                occluded=None, tape=None):
    """Full per-sample radiance estimate (pathTrace, :300-418).

    origin/direction: [R, 3] f32; state: [R] int64 RNG.
    tape: None (plain render), "record" (returns (radiance, tape)), or a
    tape recorded earlier (playback: `nearest`/`occluded` may be None and
    no traversal or per-query sort runs).  Returns radiance [R, 3] (and the
    tape when recording).
    """
    record = tape == "record"
    play = tape is not None and not record
    mode = "record" if record else ("play" if play else "off")
    R = origin.shape[0]
    if occluded is None and not play:
        def occluded(o, d, max_dist):  # any-hit via the nearest-hit search
            s = nearest(o, d)
            return s["hit"] & (s["t"] < max_dist)

    radiance = torch.zeros_like(origin)
    throughput = torch.ones_like(origin)
    active = torch.ones((R,), dtype=torch.bool, device=origin.device)

    # One primary trace shared by the direct-view pass and bounce 0; the
    # primary stream keeps raster order (no coherence sort).
    if play:
        tri1 = tape["prim"]["tri1"]
        prim = {"hit": tri1 >= 0, "tri": tri1.clamp(min=0),
                "t": tape["prim"]["t"]}
    else:
        prim = getattr(nearest, "unsorted", nearest)(origin.detach(),
                                                     direction.detach())
    tape_out = {}
    if record:
        tape_out["prim"] = {"tri1": _tri_or_miss(prim), "t": prim["t"]}
    if cfg.direct_light_view:
        dv_done, dv_value = _direct_view_pass(origin.detach(),
                                              direction.detach(), scene, prim)
    else:
        dv_done = torch.zeros((R,), dtype=torch.bool, device=origin.device)
        dv_value = radiance

    body = make_bounce_body(scene, nearest, occluded, cfg)
    if cfg.wavefront_sort:
        body = _wavefront_sorted(body, nearest, scene)
    carry = (origin, direction, throughput, radiance, active, state)

    C = capacity(R, cfg.compact_frac)
    if 0 < C < R:
        perm, n_live = _compaction_order(prim, origin, direction, scene, C)
        k = perm.shape[0] // C
        # Row R takes the pad entries' results and is dropped.
        out = torch.zeros((R + 1, 3), dtype=origin.dtype,
                          device=origin.device)
        tape_chunks, n_run = [], 0
        for c in range(k):
            # Chunk 0 always runs (an all-dead chunk gives exact zeros);
            # chunk c > 0 only when it holds live lanes.  The live lanes
            # come first, so the first chunk without any ends the loop.
            # Reading n_live here waits for the primary only: chunk 0 is
            # queued by then.
            if c and n_live.value() <= c * C:
                break
            if play and c >= len(tape["chunks"]):
                raise ValueError(f"the tape holds {len(tape['chunks'])} "
                                 "chunks, its primary selects more")
            idx = perm[c * C:(c + 1) * C]
            carry_c, prim_c = _chunk(carry, prim, idx, R, (c + 1) * C > R)
            rad_c = _run_bounces(body, carry_c, prim_c, cfg, mode,
                                 tape["chunks"][c] if play else None)
            if record:
                rad_c, entries = rad_c
                tape_chunks.append(entries)
            out = out.index_copy(0, idx, rad_c)
            n_run += 1
        if play and n_run != len(tape["chunks"]):
            raise ValueError(f"the tape holds {len(tape['chunks'])} "
                             f"chunks, its primary selects {n_run}")
        radiance = out[:R]
        if record:
            tape_out["chunks"] = tape_chunks
    else:
        radiance = _run_bounces(body, carry, prim, cfg, mode,
                                tape["body"] if play else None)
        if record:
            radiance, tape_out["body"] = radiance

    radiance = torch.where(dv_done[:, None], dv_value, radiance)
    if record:
        return radiance, tape_out
    return radiance

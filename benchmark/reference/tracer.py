"""The plain reference path tracer.

Written from the reference shader's equations (raytrace_comp.comp, the
line numbers below) in plain PyTorch, every lane in lockstep with an
`active` mask: the counter RNG (:209-216, seeded per pixel and sample
batch at :435), thin-lens rays with Gaussian jitter (:420-464), the
direct view of the area lights (:309-328), and per bounce the nearest hit
(:159-204), next-event estimation against every light (:341-367), the
subsurface walk (:370-408) and the cosine-weighted bounce (:411-414).  It
has no compaction, no ray sort and no tape: each of those may reorder
lanes but may not change a pixel, so the reference checks them too.

Hit selection is detached and the hit's t, position and normal are
recomputed from the selected triangle, so autograd through `render`
gives the gradient of the image with respect to the albedo.

`q` rounds every radiance-path quantity (albedo and light terms,
throughputs, contributions, sums) after each step: the identity for the
reference, a round trip through bfloat16 for its control.
"""

from __future__ import annotations

import torch

from .accel import Tree

MASK32 = 0xFFFFFFFF
PI = 3.14159265358979323846


def exact(x):
    return x


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


# --- counter RNG (:209-216) ---------------------------------------------------

def seed(sample_batch, px, py, width, height):
    sb = int(sample_batch) & MASK32
    s = (sb * height + py) & MASK32
    return (s * width + px) & MASK32


def uniform(state):
    state = (state * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    word = (word >> 22) ^ word
    return state, word.to(torch.float32) / 4294967296.0


# --- vectors and sampling --------------------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-20)


def const(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def gaussian2(state):
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-38)))
    th = (2.0 * PI) * u2
    return state, torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)


def hemisphere(normal, state):
    state, r1 = uniform(state)
    state, r2 = uniform(state)
    theta = torch.arccos(torch.sqrt(torch.clamp(1.0 - r1, 0.0, 1.0)))
    phi = (2.0 * PI) * r2
    st = torch.sin(theta)
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                         torch.cos(theta)], -1)
    up = torch.where((normal[..., 2].abs() < 0.999)[..., None],
                     const([0.0, 0.0, 1.0], normal),
                     const([1.0, 0.0, 0.0], normal))
    tangent = normalize(cross(up, normal))
    bitangent = cross(normal, tangent)
    return state, (tangent * local[..., 0:1] + bitangent * local[..., 1:2]
                   + normal * local[..., 2:3])


def sphere(state):
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    z = 2.0 * u1 - 1.0
    th = (2.0 * PI) * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return state, torch.stack([r * torch.cos(th), r * torch.sin(th), z], -1)


def light_frame(normal):
    basis = torch.where((normal[..., 1].abs() < 0.999)[..., None],
                        const([0.0, 1.0, 0.0], normal),
                        const([1.0, 0.0, 0.0], normal))
    right = normalize(cross(normal, basis))
    return right, cross(right, normal)


class Scene:
    """The inputs of a render, as plain tensors on one device.

    mesh: vertices [V, 3] float32, indices [T, 3]; material: one
    material's albedo [3], roughness, emission [3], sss_albedo [3],
    sss_radius; lights: (position [3], normal [3], intensity [3], size [2])
    each; settings: the render's numbers (RenderConfig's names)."""

    def __init__(self, vertices, indices, material, lights, settings):
        self.vertices = vertices.float()
        self.indices = indices.long()
        self.tree = Tree(self.vertices, self.indices, settings["eps"])
        dev = self.vertices.device
        self.material = {k: torch.as_tensor(v, dtype=torch.float32,
                                            device=dev)
                         for k, v in material.items()}
        self.lights = []
        for pos, nrm, inten, size in lights:
            n = torch.as_tensor(nrm, dtype=torch.float32, device=dev)
            self.lights.append((
                torch.as_tensor(pos, dtype=torch.float32, device=dev),
                n / torch.clamp(torch.linalg.vector_norm(n), min=1e-20),
                torch.as_tensor(inten, dtype=torch.float32, device=dev),
                torch.as_tensor(size, dtype=torch.float32, device=dev)))
        self.s = settings

    # --- rays (:420-464) ------------------------------------------------------

    def rays(self, camera, sample_batch, rows):
        """Origins, directions and RNG states of every pixel of `rows`."""
        W, H = self.s["width"], self.s["height"]
        dev = self.vertices.device
        py = rows.long()[:, None].expand(-1, W).reshape(-1)
        px = torch.arange(W, device=dev).repeat(rows.numel())
        state = seed(sample_batch, px, py, W, H)
        ndc_x = 2.0 * px.to(torch.float32) / W - 1.0
        ndc_y = 2.0 * py.to(torch.float32) / H - 1.0
        pos, cdir, cup, fov = (torch.as_tensor(camera[k], dtype=torch.float32,
                                               device=dev)
                               for k in ("position", "direction", "up",
                                         "fov_deg"))
        cdir = normalize(cdir)
        right = normalize(cross(cdir, -cup))
        up = normalize(cross(right, cdir))
        dof = self.s["enable_dof"]
        state, g = gaussian2(state)
        origin = pos + (right * g[:, 0:1] + up * g[:, 1:2]) * (
            self.s["aperture"] if dof else 0.0)
        state, g = gaussian2(state)
        ndc_x = ndc_x + g[:, 0] * self.s["aa_jitter"] / W
        ndc_y = ndc_y + g[:, 1] * self.s["aa_jitter"] / H
        tan_fov = torch.tan(torch.deg2rad(fov * 0.5))
        base = normalize(cdir + (ndc_x * tan_fov * (W / H))[:, None] * (-right)
                         - (ndc_y * tan_fov)[:, None] * up)
        if dof:
            return (origin,
                    normalize(pos + base * self.s["focal_distance"] - origin),
                    state)
        return origin, base, state

    # --- surfaces --------------------------------------------------------------

    def surface(self, o, d, tri, hit):
        """t, position and normal of the selected triangle, recomputed."""
        idx = self.indices[tri]
        v0, v1, v2 = (self.vertices[idx[:, k]] for k in range(3))
        e1, e2 = v1 - v0, v2 - v0
        pvec = cross(d, e2)
        det = dot(e1, pvec)
        inv = 1.0 / torch.where(det.abs() < self.s["eps"],
                                torch.ones_like(det), det)
        t = inv * dot(cross(o - v0, e1), e2)
        pos = o + d * t[:, None]
        n = normalize(cross(e1, e2))
        m = hit[:, None]
        return (torch.where(hit, t, torch.ones_like(t)),
                torch.where(m, pos, torch.zeros_like(pos)),
                torch.where(m, n, const([0.0, 0.0, 1.0], n).expand_as(n)))

    def nearest(self, o, d, active):
        return self.tree.nearest(o.detach(), d.detach(), active)

    def nee(self, state, pos, normal, albedo, light, mask, q, view=None):
        """Direct light from one rectangle (:345-366)."""
        lpos, lnrm, lint, lsize = light
        state, u = uniform(state)
        state, v = uniform(state)
        right, up = light_frame(lnrm)
        point = (lpos + right * ((u * 2.0 - 1.0) * lsize[0] * 0.5)[:, None]
                 + up * ((v * 2.0 - 1.0) * lsize[1] * 0.5)[:, None])
        to_light = point - pos
        ldist = torch.linalg.vector_norm(to_light, dim=-1)
        ldir = to_light / torch.clamp(ldist, min=1e-20)[:, None]
        diffuse = torch.clamp(dot(normal, ldir), min=0.0)
        if view is not None:
            diffuse = diffuse * self.oren_nayar(normal, ldir, view)
        off = self.s["offset"]
        occ = self.tree.occluded(
            (pos + normal * off).detach(), ldir.detach(),
            torch.where(mask, ldist.detach() - off,
                        torch.full_like(ldist, -1.0)), mask)
        contrib = q(q(albedo * q(lint)) * q(diffuse / torch.clamp(
            ldist * ldist, min=0.01))[:, None])
        return state, torch.where(((~occ) & mask)[:, None], contrib,
                                  torch.zeros_like(contrib))

    def oren_nayar(self, n, l, v):
        sigma = self.material["roughness"]
        cos_i, cos_r = dot(n, l), dot(n, v)
        s = dot(l, v) - cos_i * cos_r
        t = torch.where(s > 0.0, torch.clamp(torch.maximum(cos_i, cos_r),
                                             min=1e-6), torch.ones_like(s))
        s2 = sigma * sigma
        a = 1.0 - 0.5 * s2 / (s2 + 0.33)
        b = 0.45 * s2 / (s2 + 0.09)
        return a + b * torch.clamp(s, min=0.0) / t

    def sss(self, state, pos, normal, throughput, hit, q):
        """The subsurface walk below a hit (:370-408)."""
        mat = self.material
        off = self.s["offset"]
        add = torch.zeros_like(pos)
        sss_tp = torch.ones_like(pos)
        live = hit
        state, d = sphere(state)
        o = pos - normal * off
        inv_atten = 1.0 / torch.clamp(mat["sss_radius"] * 1.5, min=1e-6)
        weight = q(1.0 + mat["sss_radius"] * 0.5)
        albedo = q(mat["sss_albedo"])
        for _ in range(self.s["sss_bounces"]):
            found, _, tri = self.nearest(o, d, live)
            sh = found & live
            t, cur_n = self.surface(o, d, tri, sh)[0::2]
            cur = o + d * t[:, None]
            light = torch.zeros_like(pos)
            for lt in self.lights:
                state, c = self.nee(state, cur, cur_n, albedo, lt, sh, q)
                light = q(light + c)
            add = q(add + q(q(q(throughput * sss_tp) * light) * weight))
            atten = q(torch.exp(-t[:, None] * inv_atten))
            sss_tp = torch.where(sh[:, None], q(q(sss_tp * albedo) * atten),
                                 sss_tp)
            live = sh
            state, nd = sphere(state)
            o = torch.where(sh[:, None], cur - cur_n * off, o)
            d = nd
        return state, add

    def direct_view(self, o, d, hit, t):
        """A light seen by the primary ray before any surface (:309-328)."""
        done = torch.zeros_like(hit)
        value = torch.zeros_like(o)
        for lpos, lnrm, lint, lsize in self.lights:
            denom = dot(lnrm, d)
            parallel = denom.abs() < 1e-4
            lt = dot(lnrm, lpos - o) / torch.where(parallel,
                                                   torch.ones_like(denom),
                                                   denom)
            to_hit = o + d * lt[:, None] - lpos
            right, up = light_frame(lnrm)
            inside = ((dot(to_hit, right).abs() <= lsize[0] * 0.5)
                      & (dot(to_hit, up).abs() <= lsize[1] * 0.5))
            seen = (~parallel) & (lt > 0.0) & inside & ((~hit) | (t > lt))
            newly = seen & (~done)
            value = torch.where(newly[:, None], lint.expand_as(value), value)
            done = done | newly
        return done, value

    # --- a path per pixel (:300-418) -------------------------------------------

    def radiance(self, o, d, state, albedo, q=exact):
        R = o.shape[0]
        active = torch.ones((R,), dtype=torch.bool, device=o.device)
        prim_hit, prim_t, prim_tri = self.nearest(o, d, active)
        dv_done, dv_value = self.direct_view(o.detach(), d.detach(),
                                             prim_hit, prim_t)
        albedo = q(albedo)
        emission = q(self.material["emission"])
        off = self.s["offset"]
        throughput = torch.ones_like(o)
        rad = torch.zeros_like(o)
        for depth in range(self.s["max_depth"]):
            if depth == 0:
                found, tri = prim_hit, prim_tri
            else:
                found, _, tri = self.nearest(o, d, active)
            hit = found & active
            _, pos, normal = self.surface(o, d, tri, hit)
            rad = q(rad + torch.where(hit[:, None], q(throughput * emission),
                                      torch.zeros_like(rad)))
            direct = torch.zeros_like(rad)
            for lt in self.lights:
                state, c = self.nee(state, pos, normal, albedo, lt, hit, q,
                                    view=-d)
                direct = q(direct + c)
            rad = q(rad + q(throughput * direct))
            if self.s["enable_sss"]:
                state, add = self.sss(state, pos, normal, throughput, hit, q)
                rad = q(rad + add)
            state, bdir = hemisphere(normal, state)
            cos_b = torch.clamp(dot(normal, bdir), min=0.0)
            throughput = torch.where(
                hit[:, None], q(q(throughput * albedo) * cos_b[:, None]),
                throughput)
            o = torch.where(hit[:, None], pos + normal * off, o)
            d = torch.where(hit[:, None], bdir, d)
            active = hit
        return torch.where(dv_done[:, None], q(dv_value), rad)

    def render(self, camera, sample_batch, rows, albedo=None, q=exact):
        """The radiance [len(rows) * width, 3] of every pixel of `rows` for
        one sample batch (one sample per pixel)."""
        if albedo is None:
            albedo = self.material["albedo"]
        o, d, state = self.rays(camera, sample_batch, rows)
        return self.radiance(o, d, state, albedo, q)


def accumulate(prev, new, batch, q=exact):
    """The progressive mean (:467-469)."""
    b = float(batch)
    return q(q(q(prev * b) + new) / (b + 1.0))


def row_blocks(height, width, budget=1 << 20):
    """Whole-row blocks of at most `budget` pixels covering the frame."""
    per = max(1, budget // width)
    return [torch.arange(r, min(r + per, height)) for r in range(0, height,
                                                                   per)]


def adam(param, grad, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update (Kingma and Ba, Algorithm 1): (param, m, v)."""
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1 ** step)
    v_hat = v / (1.0 - b2 ** step)
    return param - lr * m_hat / (torch.sqrt(v_hat) + eps), m, v


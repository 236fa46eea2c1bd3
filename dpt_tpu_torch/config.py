"""Render configuration and named presets.

Counterpart of `dpt_tpu/config.py`: the same frozen dataclass, field for
field, and the same five presets, so a configuration round-trips between the
two packages.  Fields that only steer TPU execution (`packet_tile`,
`interleave`) are accepted and have no effect here.  Options whose code path
is not ported yet raise `NotImplementedError` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses

# traversal value -> the ROADMAP item that ports it.
_UNPORTED_TRAVERSALS = {
    "bvh": "ROADMAP Queue 1 item 6 (LBVH and the other traversals)",
    "packet": "ROADMAP Queue 1 item 6 (LBVH and the other traversals)",
    "threaded": "ROADMAP Queue 1 item 6 (LBVH and the other traversals)",
}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render configuration. Hashable, immutable."""

    width: int = 1024
    height: int = 1024
    # Bounce loop depth; reference MAX_DEPTH=4 (raytrace_comp.comp:304).
    max_depth: int = 4
    # Samples per pixel per render_sample call.
    spp: int = 1
    # Progressive accumulation batches (reference NUM_SAMPLE_BATCHES=1024).
    sample_batches: int = 1024

    # --- feature toggles -------------------------------------------------
    # Direct-view area-light pass (raytrace_comp.comp:309-328).
    direct_light_view: bool = True
    # Subsurface random walk (raytrace_comp.comp:370-408).
    enable_sss: bool = True
    sss_bounces: int = 3
    # Russian-roulette termination (absent from the reference, whose depth
    # loop is fixed, raytrace_comp.comp:331).
    russian_roulette: bool = False
    rr_start_depth: int = 2
    # Thin-lens depth of field + Gaussian AA jitter (raytrace_comp.comp:440-460).
    enable_dof: bool = True
    aperture: float = 0.02
    focal_distance: float = 3.0
    aa_jitter: float = 0.5  # px; raytrace_comp.comp:452

    # --- shading ----------------------------------------------------------
    # UV-driven albedo texture: 'none' (reference parity) or 'checker'.
    uv_texture: str = "none"
    uv_texture_scale: float = 8.0

    # --- numerics --------------------------------------------------------
    # Self-intersection offset (raytrace_comp.comp:305).
    offset: float = 1e-3
    # Triangle-intersection epsilon of the brute-force search
    # (raytrace_comp.comp:116).  The quad and paired-children walks
    # hard-code 1e-6 as the TPU kernels do.
    eps: float = 1e-6
    t_max: float = 1e30

    # --- acceleration / execution ---------------------------------------
    # 'brute' : test all triangles per ray (oracle, small scenes)
    # 'quad'  : 4-wide BVH walk (the flagship path; CUDA kernel K1)
    # 'pallas': paired-children binary BVH walk (CUDA kernel K2)
    # 'bvh', 'packet', 'threaded' : not ported yet (raise).
    traversal: str = "brute"
    # Rays per traversal chunk for 'threaded' (not ported; kept for parity).
    traversal_chunk: int = 128 * 1024
    # BVH builder: 'median' or 'sah' (host numpy builds).
    bvh_builder: str = "median"
    bvh_stack_depth: int = 64  # reference uses 32 (raytrace_comp.comp:162)
    bvh_leaf_size: int = 4  # triangles per leaf (reference: 1)
    # TPU tiling knobs of the JAX package: accepted, no effect here.
    packet_tile: int = 256
    interleave: int = 8
    # Nearest-hit search of the brute traversal: 'none' (the plain search,
    # render/intersect.py) or 'intersect' (CUDA kernel K3,
    # kernels/intersect.py).  Other traversals ignore it, as in the JAX
    # package.
    kernels: str = "none"
    # Coherence-sort every traversal query stream after the primary by
    # (active, direction octant, origin Morton) (render/compaction.py).
    ray_sort: bool = False
    # Carry-level wavefront sorting (not ported yet: ROADMAP Queue 1 item 5).
    wavefront_sort: bool = False
    # Carry compaction after the primary trace: the bounce loop runs only on
    # the lanes whose primary ray hit.  Any value > 0 turns it on (the port
    # compacts to exactly the live lanes); 0 disables.
    compact_frac: float = 0.25

    # Rematerialise in backward passes: each spp body (and, in the tape's
    # playback, each bounce) runs under torch.utils.checkpoint, so the
    # backward recomputes it instead of storing its activations.
    remat_bounces: bool = True
    # The playback's bounces are traversal-free arithmetic; this knob turns
    # their remat off separately (needs remat_bounces too).
    playback_remat_bounces: bool = True

    def __post_init__(self):
        if self.traversal in _UNPORTED_TRAVERSALS:
            raise NotImplementedError(
                f"traversal={self.traversal!r} is not ported yet: "
                f"{_UNPORTED_TRAVERSALS[self.traversal]}"
            )
        if self.wavefront_sort:
            raise NotImplementedError(
                "wavefront_sort=True is not ported yet: ROADMAP Queue 1 "
                "item 5 (carry-level wavefront sort)"
            )
        if self.kernels not in ("none", "intersect"):
            raise ValueError(
                f"unknown kernels={self.kernels!r}: 'none' or 'intersect'")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# The five BASELINE.json config presets (see BASELINE.md).
PRESETS: dict[str, RenderConfig] = {
    # 1: box.obj Cornell-style, 256², 1 bounce, 4 spp
    "box256": RenderConfig(
        width=256, height=256, max_depth=1, spp=4, traversal="brute",
        enable_sss=False, russian_roulette=False,
    ),
    # 2: box.obj 512², 4 bounces, 16 spp, NEE + Russian roulette
    "box512": RenderConfig(
        width=512, height=512, max_depth=4, spp=16, traversal="brute",
        russian_roulette=True,
    ),
    # 3: Sylveon-class 512² with SAH build + 4-wide quad walk
    "sylveon512": RenderConfig(
        width=512, height=512, max_depth=4, spp=1, traversal="quad",
        bvh_builder="sah", bvh_leaf_size=8, packet_tile=4096, interleave=1,
        ray_sort=True, compact_frac=0.125,
    ),
    # 4: Sylveon-class 1024², 64 spp
    "sylveon1024": RenderConfig(
        width=1024, height=1024, max_depth=4, spp=64, traversal="quad",
        bvh_builder="sah", bvh_leaf_size=8, packet_tile=4096, interleave=1,
        ray_sort=True, compact_frac=0.125,
    ),
    # 5: Sylveon-class 2048², 4 bounces, 128 spp
    "sylveon2048": RenderConfig(
        width=2048, height=2048, max_depth=4, spp=128, traversal="quad",
        bvh_builder="sah", bvh_leaf_size=8, packet_tile=4096, interleave=1,
        ray_sort=True, compact_frac=0.125,
    ),
}


def preset(name: str, **overrides) -> RenderConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg

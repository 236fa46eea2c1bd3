"""Counter-based RNG matching the reference's per-pixel hash stream.

Counterpart of `dpt_tpu/render/rng.py`, bit-exact.  The JAX package works in
uint32; torch's uint32 has no add or shift on the CPU, so states here are
int64 tensors holding values in [0, 2**32), and every step that can pass
2**32 is wrapped with `& 0xFFFFFFFF`.  No torch.Generator is involved: the
stream is a pure function of (sample batch, pixel).

Seed (raytrace_comp.comp:435): seed = (sample_batch * H + y) * W + x.
Step (raytrace_comp.comp:209-216): PCG-variant LCG + output hash.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MUL = 747796405
_INC = 2891336453
_XSH = 277803737
# float32(4294967295.0) == 2**32, as in the JAX package's np.float32 constant.
_U32_MAX_F = 4294967296.0


def seed_pixels(sample_batch, px, py, width: int, height: int):
    """Per-pixel seed [R] int64, with the uint32 wrap after each step."""
    sb = int(sample_batch) & MASK32
    s = (sb * (height & MASK32) + py) & MASK32
    return (s * (width & MASK32) + px) & MASK32


def rng_next(state):
    """One generator step → (new_state, uniform float32 in [0, 1])."""
    state = (state * _MUL + _INC) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * _XSH) & MASK32
    word = (word >> 22) ^ word
    return state, word.to(torch.float32) / _U32_MAX_F


def rng_next_n(state, n: int):
    """Draw n uniforms; returns (state, tuple of n tensors)."""
    outs = []
    for _ in range(n):
        state, u = rng_next(state)
        outs.append(u)
    return state, tuple(outs)

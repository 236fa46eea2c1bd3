"""P6: P5 with the tile's any(hit) added into the next index.

Counterpart of `scripts/attic/probe_interleave_any.py` (`make(P)`,
pallas_call :97): the same P chains of `iters` steps as P5
(`probe_interleave`), but the next record is floor_mod(trunc(rec[12]) + rid
+ any(hit), 8192), where any(hit) is the OR over the whole [8, 128] tile,
like the real walk's any(lhit) descent decision: the reduction sits on the
chain of dependent loads.  The loop still runs `iters` steps.  On the card
the tile is spread over one thread-block cluster of 8 blocks, and the any
is a warp vote, a word per warp stored into every block's shared memory
(st.async) and one mbarrier wait a step for all P chains (csrc/probes/
interleave.cu); the chain index stays the same in every thread.

`make(P, iters)` returns `go(nodes, *rays_flat)` -> (P x [8, 128] f32, sink
[P, 3] int32), as P5's; its kernel launch and plain version are P5's
`launch` and `interleave_reference` with `any_in_index=True`.

    python -m dpt_tpu_torch.probes.probe_interleave_any

is P5's main: it times both kernels in turns (P6's cost over P5 is one of
its answers).
"""

from __future__ import annotations

from dpt_tpu_torch.probes.probe_interleave import ITERS, make_go, survey


def make(P, iters=ITERS):
    """go(nodes [1024, 128], *rays_flat) -> (P x [8, 128] f32, sink)."""
    return make_go(P, iters, True)


def main():
    survey()


if __name__ == "__main__":
    main()

"""Metrics: rays/sec accounting and structured JSONL logging.

A copy of `dpt_tpu/utils/metrics.py` (no framework imports).

Replaces the reference's qDebug ms/FPS prints (VulkanRayTracer.cpp:849-852)
with structured per-step metrics.  Ray accounting follows SURVEY §3.3's cost
model: per pixel-sample, 1 direct-view traversal + per bounce (1 primary +
L shadow + sss_bounces x (1 walk + L shadow)).
"""

from __future__ import annotations

import json
import sys
import time


def traversals_per_sample(cfg, n_lights: int) -> int:
    per_bounce = 1 + n_lights
    if cfg.enable_sss:
        per_bounce += cfg.sss_bounces * (1 + n_lights)
    total = cfg.max_depth * per_bounce
    if cfg.direct_light_view:
        total += 1
    return total


def effective_traversals_per_sample(cfg, n_lights: int, live_in) -> float:
    """Traversals per pixel-sample counting only live lanes.

    `live_in[k]` is the fraction of lanes alive *entering* bounce k
    (live_in[0] == 1.0 for primary rays); see
    renderer.live_fraction_by_depth.  The gross count
    (traversals_per_sample) charges every lane for all 33 traversals —
    fine for round-over-round deltas, misleading for MFU/speed-of-light
    claims (VERDICT r2 weak #4)."""
    per_bounce = 1 + n_lights
    if cfg.enable_sss:
        per_bounce += cfg.sss_bounces * (1 + n_lights)
    total = sum(per_bounce * live_in[k] for k in range(cfg.max_depth))
    if cfg.direct_light_view:
        total += 1.0
    return total


class JsonlLogger:
    """Append-only JSONL metrics sink (stdout by default); `common` fields
    lead every row."""

    def __init__(self, path=None, **common):
        self._f = open(path, "a") if path else sys.stdout
        self._owns = path is not None
        self._common = common

    def log(self, **fields):
        fields = {**self._common, **fields}
        fields.setdefault("ts", time.time())
        self._f.write(json.dumps(fields) + "\n")
        self._f.flush()

    def close(self):
        if self._owns:
            self._f.close()

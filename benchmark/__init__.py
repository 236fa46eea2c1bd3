"""The benchmark of dpt_tpu_torch: `python3 benchmark/run.py`, driven by
BENCHMARK.json at the repository's root."""

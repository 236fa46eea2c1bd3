"""The dry run's own check that compaction is live per rank
(`dpt_tpu_torch/entry.py` `dryrun_rank`), the twin of
`__graft_entry__.py`'s assertion 0 < C < R/dev.

  - `dryrun_config` at 1 to 8 ranks gives each rank a static capacity C
    with 0 < C < its rays, by the graft entry's own arithmetic, written out
    here (ceil(R x compact_frac / 128) x 128, R = pixels / ranks).
  - A config whose capacity covers every ray of a rank (or is 0) makes
    `dryrun_rank` raise before it renders anything.
"""

import pytest

from dpt_tpu_torch import entry


@pytest.mark.parametrize("ranks", range(1, 9))
def test_dryrun_config_compaction_live(ranks):
    cfg = entry.dryrun_config(ranks)
    r_per_rank = cfg.n_pixels // ranks
    cap = -(-int(r_per_rank * cfg.compact_frac) // 128) * 128
    assert 0 < cap < r_per_rank
    assert entry.dryrun_capacity(cfg, ranks) == (cap, r_per_rank)


@pytest.mark.parametrize("compact_frac", [1.0, 0.0])
def test_dryrun_rank_refuses_dead_compaction(monkeypatch, compact_frac):
    """C = R (every ray fits one chunk) or C = 0 (compaction off): the
    chunked-overflow branch would not run, so the dry run raises."""
    live = entry.dryrun_config

    monkeypatch.setattr(entry, "dryrun_config",
                        lambda n: live(n).replace(compact_frac=compact_frac))
    with pytest.raises(AssertionError, match="compaction not live"):
        entry.dryrun_rank("cpu")

"""Environment-variable overrides for implementation-choice knobs.

Several hot stages have two (or more) semantically identical
implementations whose relative cost depends on the preset's static shapes
— e.g. the boundary-table builder (ops/voxelize._kth_true_positions:
binary search vs rank scatter) or the face-stats segment reduction
(features/faces._label_segment_sum: one-hot matrix product vs
scatter-add). Defaults come from measured cost models; equivalence of the
alternatives is pinned by CPU tests either way.

These env knobs let an on-chip A/B flip ONE implementation per process
without source edits — the same role XLA_FLAGS plays for XLA's own
choices. They are read once at import and participate in jit cache keys
only through the Python-level branch they select (one process = one
setting; never flip mid-process). Each is to be measured on the GPU and
then deleted (ROADMAP D2).

Knobs (unset = built-in default):
  FCCF_KTH_IMPL            auto | bsearch | scatter
  FCCF_SCATTER_STATS_MIN_V integer V threshold for the scatter face stats
  FCCF_SEED_COL_BLOCKED    0 | 1   column-blocked cluster seed scan
"""

from __future__ import annotations

import os


def env_choice(name: str, default: str, allowed: tuple[str, ...]) -> str:
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    if v not in allowed:
        raise ValueError(f"{name}={v!r}: expected one of {allowed}")
    return v


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "").strip()
    return int(v) if v else default


def env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{name}={v!r}: expected a boolean (0/1)")

"""The hot co-sorts: one entry point for every key-sort that moves
payloads ("payloads ride the sort network" instead of post-hoc
permutation gathers, ops/voxelize.py).

``jax.lax.sort`` is the implementation. A hand-written bitonic co-sort
kernel was built for the accelerator the system was first written for
and removed after it lost to XLA's variadic sort at the primary call-site
shape (office fused voxelize, 65536 rows, 1 int32 key + 3 f32 payloads):
an O(n log^2 n) network does not beat an O(n log n) sort at the shapes
that matter, and what the sorts cost is their *volume* (row count x call
count), which capacity tightening attacks directly (models/fccf.py) —
not per-sort overhead. Whether a key+index sort followed by a gather
beats the co-sort on the GPU is ROADMAP S5.

``site`` names the hot call site (downsample | stats | fused | table |
join); it is retained in the signature so call sites stay
self-documenting and a future per-site implementation experiment has
its hooks, but it selects nothing today.
"""

from __future__ import annotations

import jax

SITES = ("downsample", "stats", "fused", "table", "join")


def cosort(keys, payloads=(), stable: bool = True, site: str | None = None):
    """Sort ``(*keys, *payloads)`` by the lexicographic ``keys``;
    equivalent to ``jax.lax.sort((*keys, *payloads), num_keys=len(keys),
    is_stable=stable)`` and returns the same tuple."""
    if site is not None and site not in SITES:
        raise ValueError(f"unknown sort site {site!r}: expected one of {SITES}")
    keys = tuple(keys)
    payloads = tuple(payloads)
    return jax.lax.sort(
        (*keys, *payloads), num_keys=len(keys), is_stable=stable
    )

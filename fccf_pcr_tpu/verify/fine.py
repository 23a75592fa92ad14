"""Fine verification: voxel-occupancy overlap score on the residual clouds.

Rebuild of ``fine_verify`` (FCCF.cpp:785-839, C12): fuse the source residual
cloud (label 0) with the transformed target residual cloud (label 1), voxel
at 0.5 m, and for every voxel holding both labels add
(s + t) * min(s,t)/max(s,t); score = sum / total points.

Tensor redesign (no octree, no per-candidate tree build):
  - residual points are compacted once per pair into fixed-capacity arrays;
  - voxel cells are absolute-anchored ``floor(p / res)`` packed into one
    int32 key (10 bits per axis with wraparound — exact for scenes under
    ~512 m per axis, far beyond the ETH scenes; the spare low bit carries
    the source/target label through the join sort);
  - the *source* cloud never moves across candidates, so its (sorted unique
    key, count) table is built once; each candidate stable-sorts
    [source unique keys ++ its transformed target keys] and propagates run
    boundaries (no ``jnp.searchsorted`` anywhere — it lowers to a while
    loop of full-width binary-search gathers; see ``fine_verify``).

The denominator ``allinvec`` (:829) sums every occupied voxel's points,
i.e. exactly the total number of fused points.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Capacities, FCCFParams
from ..ops.sorting import cosort

# Keys are 30-bit packed cells promoted to uint32; after the label-bit shift
# in fine_verify they span 31 bits, so the all-ones uint32 can never collide
# with a real key in either domain (no axis range is sacrificed to protect
# the sentinel).
_SENTINEL = np.uint32(0xFFFFFFFF)


def _cells(points, res):
    """Integer voxel cell per point (absolute anchoring, floor(p/res))."""
    return jnp.floor(points / res).astype(jnp.int32)


def _cell_bounds(cells, mask):
    """Per-axis (min, max) over the valid cells; empty masks yield an
    inverted range so the span test below cannot fire."""
    big = jnp.int32(1 << 30)
    kmin = jnp.min(jnp.where(mask[..., None], cells, big), axis=-2)
    kmax = jnp.max(jnp.where(mask[..., None], cells, -big), axis=-2)
    return kmin, kmax


def _pack_cells(cells, mask):
    """30-bit packed voxel cell (10 bits/axis with wraparound — injective
    while the joint scene span stays under 1024 cells per axis, ~512 m at
    the 0.5 m default; ``fine_verify`` checks the span and flags aliasing
    otherwise instead of degrading silently). The spare low bit carries the
    source/target label through the join sort (see fine_verify), saving a
    payload operand."""
    kx = (cells[..., 0] & 1023).astype(jnp.uint32)   # 10 bits
    ky = (cells[..., 1] & 1023).astype(jnp.uint32)   # 10 bits
    kz = (cells[..., 2] & 1023).astype(jnp.uint32)   # 10 bits
    key = (kx << 20) | (ky << 10) | kz
    return jnp.where(mask, key, _SENTINEL)


def _unique_counts(keys, cap):
    """Sorted unique keys + counts (fixed capacity, sentinel-padded).

    Returns (ukeys, counts, overflow): overflow is True when the number of
    distinct keys exceeds ``cap`` (excess voxels are dropped).

    Run boundaries come from unique-index scatters of first/last run
    positions (jnp.searchsorted lowers to a gather-round while loop)."""
    n = keys.shape[0]
    with jax.named_scope("table_sort"):
        (s,) = cosort((keys,), site="table")
    valid = s != _SENTINEL
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]]) & valid
    n_unique = jnp.sum(first.astype(jnp.int32))
    seg = jnp.minimum(jnp.cumsum(first.astype(jnp.int32)) - 1, cap)
    idx = jnp.arange(n, dtype=jnp.int32)
    # Run ids are dense-consecutive, so each run ends where the next one
    # starts: ONE scatter builds the start table, end follows elementwise
    # (one N-update scatter instead of two).
    # Index cap is out of bounds for the (cap,) buffer -> dropped, keeping
    # the surviving scatter indices genuinely unique.
    start = (
        jnp.full((cap,), -1, jnp.int32)
        .at[jnp.where(first, seg, cap)]
        .set(idx, mode="drop", unique_indices=True)
    )
    slot = jnp.arange(cap, dtype=jnp.int32)
    R = jnp.minimum(n_unique, cap)
    occupied = slot < R
    # last KEPT run ends at the last element of runs < cap (overflow runs
    # are parked at seg == cap and excluded)
    n_valid_kept = jnp.sum((valid & (seg < cap)).astype(jnp.int32))
    nxt_start = jnp.concatenate([start[1:], jnp.zeros((1,), jnp.int32)])
    end = jnp.where(slot == R - 1, n_valid_kept - 1, nxt_start - 1)
    counts = jnp.where(occupied, (end - start + 1).astype(jnp.float32), 0.0)
    ukeys = jnp.where(occupied, s[jnp.maximum(start, 0)], _SENTINEL)
    return ukeys, counts, n_unique > cap


class SourceTable(NamedTuple):
    keys: jax.Array    # (Vf,) sorted unique voxel keys (sentinel padded)
    counts: jax.Array  # (Vf,) float counts
    n_src: jax.Array   # () total source residual points
    overflow: jax.Array  # () bool, > max_fine_voxels distinct cells (dropped)
    cell_min: jax.Array  # (3,) int32 per-axis min source cell (join window)
    cell_max: jax.Array  # (3,) int32 per-axis max source cell
    aliased: jax.Array   # () bool, source span >= 1024 cells on some axis:
    #   the table's own wrapped keys merged distinct voxels (flagged;
    #   in-window join keys are injective whenever this is False)


def build_source_table(src_pts, src_mask, params: FCCFParams, caps: Capacities):
    cells = _cells(src_pts, params.fine_voxel)
    keys = _pack_cells(cells, src_mask)
    kmin, kmax = _cell_bounds(cells, src_mask)
    ukeys, counts, overflow = _unique_counts(keys, caps.max_fine_voxels)
    return SourceTable(
        keys=ukeys,
        counts=counts,
        n_src=jnp.sum(src_mask.astype(jnp.float32)),
        overflow=overflow,
        cell_min=kmin,
        cell_max=kmax,
        aliased=jnp.any(kmax - kmin >= 1024),
    )


def fine_verify(T, table: SourceTable, tar_pts, tar_mask, params, caps):
    """Score one candidate transform (:785-839).

    Returns ``(score, aliased)``: ``aliased`` is True when the SOURCE
    residual's cell span exceeds the 1024-cells-per-axis injective range of
    the packed key, i.e. when the source table's own wrapped keys could have
    merged distinct voxels (the reference's octree is extent-unbounded,
    FCCF.cpp:792-796; here the capacity contract of config.py requires the
    degradation to be *flagged*, never silent). The *target* cloud needs no
    span condition: only voxels holding both labels score (:830), so target
    cells outside the source bounding window can never contribute and are
    dropped from the join before packing — every joined cell then lies
    inside the source window, keeping wrapped keys injective for ANY
    candidate pose (degenerate 3-plane solves can emit translations
    hundreds of metres out; without the window those wrapped far cells
    could collide with real source voxels and fabricate fine score).
    Dropping them does not change the score's denominator, which counts
    fused POINTS from the original masks (:829).

    Join structure: only voxels holding BOTH labels contribute (:830), and
    those are a subset of the source voxels. The join is ONE sort of
    [source unique keys ++ transformed target keys] with the source/target
    label packed into the key's low bit (source=0 leads its cell run, so
    no stable sort and no label payload operand), followed by cummin run
    propagation. No jnp.searchsorted (which lowers to a while loop of
    binary-search rounds with full-width gathers) and no per-candidate
    octree/sort of PCL's kind.
    """
    R = T[:3, :3]
    t = T[:3, 3]
    tar_t = tar_pts @ R.T + t
    cells_t = _cells(tar_t, params.fine_voxel)
    # Join window: a target cell scores only by EQUALLING a source cell, so
    # cells outside the source bbox are dropped before packing (see
    # docstring — this keeps wrapped keys injective for any pose and cannot
    # change the score). The alias flag is the source table's own.
    in_win = jnp.all(
        (cells_t >= table.cell_min) & (cells_t <= table.cell_max), axis=-1
    )
    keys_t = _pack_cells(cells_t, tar_mask & in_win)
    aliased = table.aliased

    Vf = table.keys.shape[0]
    M = keys_t.shape[0]
    n = Vf + M
    # The source/target label rides the key's low bit (sources get 0, so
    # they lead their cell run without needing a stable sort or an is_src
    # payload operand); cell = key >> 1. Sentinels stay maximal.
    ks2 = jnp.where(table.keys != _SENTINEL, table.keys << 1, _SENTINEL)
    kt2 = jnp.where(keys_t != _SENTINEL, (keys_t << 1) | 1, _SENTINEL)
    keys = jnp.concatenate([ks2, kt2])
    vals = jnp.concatenate([table.counts, jnp.ones((M,), jnp.float32)])

    # co-sort: the count payload rides the sorting network instead of a
    # post-hoc permutation gather.
    with jax.named_scope("join_sort"):
        k_s, val_s = cosort((keys,), (vals,), site="join")
    src_s = (k_s & 1) == 0

    pos = jnp.arange(n, dtype=jnp.int32)
    cell = k_s >> 1
    start_flag = jnp.concatenate(
        [jnp.ones((1,), bool), cell[1:] != cell[:-1]]
    )
    nxt = jax.lax.cummin(
        jnp.where(start_flag, pos, jnp.int32(n)), reverse=True
    )
    nxt = jnp.concatenate([nxt[1:], jnp.full((1,), n, jnp.int32)])

    # Evaluate each run once, AT its start position — where the run's source
    # entry (if any) sits, so everything is elementwise (no gathers).
    has_src = start_flag & src_s  # run begins with a source entry
    s_cnt = jnp.where(has_src, val_s, 0.0)
    run_len = (nxt - pos).astype(jnp.float32)  # valid at start positions
    t_cnt = run_len - has_src.astype(jnp.float32)
    live = start_flag & has_src & (t_cnt >= 1.0) & (k_s != _SENTINEL)
    mn = jnp.minimum(s_cnt, t_cnt)
    mx = jnp.maximum(s_cnt, t_cnt)
    similar = jnp.sum(
        jnp.where(live, (s_cnt + t_cnt) * mn / jnp.maximum(mx, 1.0), 0.0)
    )
    total = table.n_src + jnp.sum(tar_mask.astype(jnp.float32))
    return similar / jnp.maximum(total, 1.0), aliased

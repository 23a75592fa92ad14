"""Transform-hypothesis clustering.

Rebuild of ``transform_cluster`` (FCCF.cpp:1040-1231, C15) plus the rotation
averaging helper ``average_normal`` (FCCF.cpp:325-367, C6).

Reference semantics (order-dependent) preserved EXACTLY, but computed in
parallel:

  - <= 10 hypotheses of a type: pass through unclustered; 0 -> one identity
    representative (:1043-1063).
  - otherwise greedy leader clustering: walk hypotheses in order, skipping
    already-allocated seeds AND the final element (:1084 quirk: the last
    hypothesis never seeds); a seed's cluster is every hypothesis (allocated
    or not! :1093-1115 never re-checks is_allocate) within 0.8 m translation
    radius whose rotation is within 2 deg (angle between Q.x_hat images);
    members are marked allocated.
  - clusters sorted by size desc (stable), then emitted with the adaptive
    floor walk (:1126-1229): floor starts at the max size, each undersized
    cluster decrements the floor while fewer than cluster_num/2 reps are
    emitted; emission stops when the rep list exceeds cluster_num, the
    floor reaches < 2, or an undersized cluster is hit after cluster_num/2.
  - each emitted representative is (mean translation, axis-averaged
    rotation rebuilt via two Rodrigues steps) over its members.

Parallel derivation of the seed set (replacing the reference's O(H^2)
*sequential* allocation loop): index i is a greedy seed iff

    seed_i = eligible_i  AND  NOT EXISTS j < i: seed_j AND adj(j, i)

because "allocated before i's turn" means exactly "covered by an earlier
seed's ball". Blocks of 256 indices are processed in order by a scan whose
step computes the geometric ball predicates for its rows ON THE FLY —
nothing (H, H)-shaped ever exists in device memory (an explicit adjacency
matrix at H=8192, batch 8, 3 types would move gigabytes). Intra-block
dependencies resolve with a tiny (256, 256) fixpoint. Cluster statistics
are then masked matmuls over the compacted seed rows only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Capacities, FCCFParams
from ..hypotheses.transforms import Hypotheses
from ..ops import geometry
from ..ops.voxelize import compact
from ..utils.tuning import env_bool

_XHAT = np.array([1.0, 0.0, 0.0], np.float32)
_YHAT = np.array([0.0, 1.0, 0.0], np.float32)

_SEED_BLOCK = 512

# Column-block the seed scan's ball/stats work too (a second dynamic
# bound): each row block's (B, H) predicates/matmuls become an inner loop
# of (B, B) tiles that stops at the occupied-column prefix, so scan cost
# tracks content^2 instead of content x capacity. Exact by construction
# (columns past the occupied prefix are masked in both paths — tested
# equal). Off by default: the win is the unoccupied column fraction, the
# cost is inner-loop sequencing of smaller matmuls; it is to be measured
# on the GPU (ROADMAP D2). FCCF_SEED_COL_BLOCKED=1 flips it per process.
_SEED_COL_BLOCKED = env_bool("FCCF_SEED_COL_BLOCKED", False)


class Representatives(NamedTuple):
    """Per-type cluster representatives (type-major leading axis)."""

    quat: jax.Array   # (3, C, 4)
    t: jax.Array      # (3, C, 3)
    valid: jax.Array  # (3, C) bool
    overflow: jax.Array  # () bool, any type's seed/rep capacity exceeded


def _ball_rows(t_rows, px_rows, t, px, params):
    """(B, H) geometric ball predicates: translation within cluster_dist
    (radiusSearch gate, squared) AND rotation within cluster_angle (angle
    between Q.x_hat images, :1105-1110)."""
    cos_gate = jnp.cos(jnp.deg2rad(params.cluster_angle)).astype(t.dtype)
    r2 = params.cluster_dist * params.cluster_dist
    d2 = (
        jnp.sum(t_rows * t_rows, axis=-1)[:, None]
        + jnp.sum(t * t, axis=-1)[None, :]
        - 2.0 * (t_rows @ t.T)
    )
    cosm = jnp.clip(px_rows @ px.T, -1.0, 1.0)
    return (d2 <= r2) & (cosm >= cos_gate)


def _greedy_seeds_all_types(masks, t, px, py, params):
    """Exact greedy-leader seed sets + per-slot cluster stats, one pass.

    Returns (seeds (3, H), size (3, H), sums (3, H, 9)). One ordered scan
    over index blocks; the geometric predicates for each block's rows are
    computed once, shared by the three type lanes, and consumed in-place
    for both coverage propagation and cluster statistics (members = the
    row's ball restricted to the type — allocated-or-not, per the
    reference's overlap quirk) — nothing (H, H)- or (W, H)-shaped is ever
    materialized.
    """
    n_types, H = masks.shape
    B = min(_SEED_BLOCK, H)
    assert H % B == 0, f"max_hypotheses={H} must be a multiple of {B}"
    idx = jnp.arange(H)
    last_idx = jnp.max(jnp.where(masks, idx[None, :], -1), axis=1)  # (3,)
    eligible = masks & (idx[None, :] != last_idx[:, None])
    bi = jnp.arange(B)
    lower = bi[:, None] < bi[None, :]  # [j, i] within block
    # Per-type member stats as ONE matmul: 10 columns per type lane —
    # [t, px, py, 1] zeroed outside the lane — so a block's member sums
    # and sizes are (geo @ stats_cols) with the row's type mask applied
    # AFTER the contraction. Nothing (n_types, B, H)-shaped ever
    # materializes (no bool member tensor and its f32 convert).
    stats10 = jnp.concatenate(
        [t, px, py, jnp.ones((H, 1), t.dtype)], axis=-1
    )  # (H, 10)
    stats_cols = (
        stats10[None, :, :] * masks[:, :, None].astype(t.dtype)
    )  # (3, H, 10)
    stats_cols = jnp.moveaxis(stats_cols, 0, 1).reshape(H, n_types * 10)

    # Blocks past the last valid index contain no valid rows or columns —
    # compute the occupied block count once; both the row scan's trip
    # count and (column-blocked path) the inner column loop stop there.
    n_occ = jnp.max(last_idx) + 1
    n_blocks = (n_occ + B - 1) // B

    def block(i, carry):
        covered, seeds, size, sums = carry
        b0 = i * B
        t_rows = jax.lax.dynamic_slice_in_dim(t, b0, B, 0)
        px_rows = jax.lax.dynamic_slice_in_dim(px, b0, B, 0)
        mask_rows = jax.lax.dynamic_slice_in_dim(masks, b0, B, 1)  # (3, B)
        elig_b = jax.lax.dynamic_slice_in_dim(
            eligible & ~covered, b0, B, 1
        )  # (3, B)

        if not _SEED_COL_BLOCKED:
            geo = _ball_rows(t_rows, px_rows, t, px, params)      # (B, H)
            geo_f = geo.astype(t.dtype)
            geo_sub = jax.lax.dynamic_slice_in_dim(geo, b0, B, 1)  # (B, B)
        else:
            geo_sub = _ball_rows(t_rows, px_rows, t_rows, px_rows, params)
        sub = geo_sub[None] & mask_rows[:, :, None] & mask_rows[:, None, :]
        sub_lower = sub & lower[None]

        def fix(state):
            s, changed, it = state
            cov_in = jnp.any(sub_lower & s[:, :, None], axis=1)
            new = elig_b & ~cov_in
            return new, jnp.any(new != s), it + 1

        s_b, _, _ = jax.lax.while_loop(
            lambda st: st[1] & (st[2] < B),
            fix,
            (elig_b, jnp.bool_(True), jnp.int32(0)),
        )
        # coverage from this block's seeds to all indices of their lane:
        # OR over seed rows == a (3, B) @ (B, .) count being positive
        # (counts are small integers, exact in f32).
        s_eff = (s_b & mask_rows).astype(t.dtype)  # (3, B)

        if not _SEED_COL_BLOCKED:
            cov_hits = s_eff @ geo_f               # (3, H)
            cov_new = covered | ((cov_hits > 0.5) & masks)
            # per-row cluster stats (valid wherever the row is a seed):
            # members = the row's ball restricted to the type lane
            # (allocated-or-not, the reference's overlap quirk).
            ss = geo_f @ stats_cols                # (B, 3*10)
        else:
            # Inner column loop: the same predicates/matmuls, (B, B) tiles,
            # stopping at the occupied-column prefix. Columns past n_occ
            # have masks False (coverage there is irrelevant) and zeroed
            # stats_cols rows (their contribution is exactly 0), so
            # truncating the column space at the prefix is exact.
            def col(j, cc):
                covered2, ss_acc = cc
                c0 = j * B
                t_cols = jax.lax.dynamic_slice_in_dim(t, c0, B, 0)
                px_cols = jax.lax.dynamic_slice_in_dim(px, c0, B, 0)
                geo_jb = _ball_rows(t_rows, px_rows, t_cols, px_cols, params)
                geo_jf = geo_jb.astype(t.dtype)
                sc = jax.lax.dynamic_slice_in_dim(stats_cols, c0, B, 0)
                ss_acc = ss_acc + geo_jf @ sc      # (B, 3*10)
                hits = s_eff @ geo_jf              # (3, B)
                mask_cols = jax.lax.dynamic_slice_in_dim(masks, c0, B, 1)
                cov_col = jax.lax.dynamic_slice_in_dim(covered2, c0, B, 1)
                cov_col = cov_col | ((hits > 0.5) & mask_cols)
                covered2 = jax.lax.dynamic_update_slice(
                    covered2, cov_col, (0, c0)
                )
                return covered2, ss_acc
            cov_new, ss = jax.lax.fori_loop(
                0, n_blocks, col,
                (covered, jnp.zeros((B, n_types * 10), t.dtype)),
            )

        seeds = jax.lax.dynamic_update_slice(seeds, s_b, (0, b0))
        ss = jnp.moveaxis(ss.reshape(B, n_types, 10), 1, 0)  # (3, B, 10)
        ss = ss * mask_rows[:, :, None].astype(t.dtype)
        size_b = ss[..., 9]
        sums_b = ss[..., 0:9]
        size = jax.lax.dynamic_update_slice(size, size_b, (0, b0))
        sums = jax.lax.dynamic_update_slice(sums, sums_b, (0, b0, 0))
        return (cov_new, seeds, size, sums)

    # Dynamic trip count: blocks past the last valid index skip at
    # RUNTIME (under vmap the batch runs to the longest lane). Bounded by
    # max(last_idx), not a popcount, so the skip stays correct even for
    # non-prefix masks. At the structured preset the (prefix-compacted)
    # pool fills ~60% of H, saving ~40% of the scan's ball/stats matmuls.
    (_, seeds, size, sums) = jax.lax.fori_loop(
        0,
        n_blocks,
        block,
        (
            jnp.zeros((n_types, H), bool),
            jnp.zeros((n_types, H), bool),
            jnp.zeros((n_types, H), t.dtype),
            jnp.zeros((n_types, H, 9), t.dtype),
        ),
    )
    return seeds, size, sums


def _emit_representatives(seed_valid, size, sums, cluster_num, caps):
    """Sorted emission with the adaptive floor walk (:1122-1229) over the
    selected seed clusters (size desc, hypothesis-order tie-break; the
    lexsort here is then a stable no-op kept as a guard)."""
    W = seed_valid.shape[0]
    key = jnp.where(seed_valid, size, -1.0)
    order = jnp.lexsort((jnp.arange(W), -key))
    s_seed = seed_valid[order]
    s_size = size[order]
    s_sums = sums[order]

    floor0 = jnp.maximum(s_size[0], 0.0)

    def step(carry, x):
        emitted, floor, stop = carry
        seed, sz = x
        live = seed & ~stop
        big = sz >= floor
        emit = live & big
        emitted = emitted + emit.astype(jnp.int32)
        # break after push once the rep list exceeds cluster_num (:1208-1211)
        stop_after_push = emit & (emitted.astype(jnp.float32) > cluster_num)
        under_half = emitted.astype(jnp.float32) < (cluster_num / 2.0)
        dec = live & ~big & under_half
        floor = jnp.where(dec, floor - 1.0, floor)
        stop_floor = dec & (floor < 2.0)
        stop_half = live & ~big & ~under_half
        stop = stop | stop_after_push | stop_floor | stop_half
        return (emitted, floor, stop), emit

    (_, _, _), emit = jax.lax.scan(
        step, (jnp.int32(0), floor0, jnp.bool_(False)), (s_seed, s_size)
    )

    # Compact the raw cluster sums FIRST, then build the representative
    # pose only for the <=C emitted slots, not for all W.
    C = caps.max_reps
    _, overflow, r_valid, r_size, r_sums = compact(emit, C, s_size, s_sums)
    mean_t = r_sums[:, 0:3] / jnp.maximum(r_size[:, None], 1.0)
    nt1 = geometry.normalize(r_sums[:, 3:6])
    nt2 = geometry.normalize(r_sums[:, 6:9])
    R = geometry.rotation_from_two_axes(nt1, nt2)
    q = geometry.matrix_to_quat(R)
    q = jnp.where(r_valid[:, None], q, 0.0)
    mean_t = jnp.where(r_valid[:, None], mean_t, 0.0)
    return r_valid, q, mean_t, overflow


def _cluster_one_type(
    type_mask, hyp, is_seed, size_all, sums_all, cluster_num, params, caps
):
    C = caps.max_reps
    W = caps.max_clusters
    count = jnp.sum(type_mask)

    # Branch 1: pass-through (<=10) / identity (0) (:1043-1063).
    _, _, p_valid, p_q, p_t = compact(type_mask, C, hyp.quat, hyp.t)
    id_q = jnp.zeros((C, 4)).at[0, 0].set(1.0)
    id_t = jnp.zeros((C, 3))
    id_valid = jnp.zeros((C,), bool).at[0].set(True)
    small_valid = jnp.where(count == 0, id_valid, p_valid)
    small_q = jnp.where(count == 0, id_q, p_q)
    small_t = jnp.where(count == 0, id_t, p_t)

    # Branch 2: keep the top-W seed clusters BY SIZE (ties keep hypothesis
    # order — lax.top_k returns equal values lowest-index-first), matching
    # the emission walk's own sort order, so truncation drops the smallest
    # clusters. A dropped seed only matters if it could have been emitted,
    # which requires size >= 2 (the adaptive floor walk stops below 2), so
    # overflow fires only when an emittable seed is dropped.
    key = jnp.where(is_seed, size_all, -1.0)
    top_size, top_idx = jax.lax.top_k(key, min(W, key.shape[0]))
    seed_valid = top_size > 0.0
    size = jnp.where(seed_valid, top_size, 0.0)
    sums = sums_all[top_idx]
    w_overflow = jnp.sum((size_all >= 2.0) & is_seed) > W
    g_valid, g_q, g_t, overflow = _emit_representatives(
        seed_valid, size, sums, cluster_num, caps
    )

    use_small = count <= params.cluster_count_threshold
    valid = jnp.where(use_small, small_valid, g_valid)
    q = jnp.where(use_small, small_q, g_q)
    t_out = jnp.where(use_small, small_t, g_t)
    return valid, q, t_out, (overflow | w_overflow) & ~use_small


def cluster_hypotheses(
    hyp: Hypotheses, params: FCCFParams, caps: Capacities
) -> Representatives:
    """Cluster the hypothesis pool per roughness type (driver :1437-1466).

    cluster budget per type: int(200 * count_type / count_total) (:1465).
    """
    H = hyp.valid.shape[0]
    px = geometry.quat_rotate(hyp.quat, jnp.broadcast_to(_XHAT, (H, 3)))
    py = geometry.quat_rotate(hyp.quat, jnp.broadcast_to(_YHAT, (H, 3)))

    types = jnp.arange(3, dtype=jnp.int32)
    masks = hyp.valid[None, :] & (hyp.type_[None, :] == types[:, None])
    counts = jnp.sum(masks, axis=1).astype(jnp.float32)
    total = jnp.maximum(jnp.sum(counts), 1.0)
    cluster_nums = jnp.floor(
        jnp.float32(params.select_cluster_number) * counts / total
    )

    seeds, size_all, sums_all = _greedy_seeds_all_types(
        masks, hyp.t, px, py, params
    )

    valid, q, t, ovf = jax.vmap(
        lambda m, s, sz, sm, cn: _cluster_one_type(
            m, hyp, s, sz, sm, cn, params, caps
        )
    )(masks, seeds, size_all, sums_all, cluster_nums)
    return Representatives(quat=q, t=t, valid=valid, overflow=jnp.any(ovf))

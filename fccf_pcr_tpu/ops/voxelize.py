"""Voxel hashing, grouping and per-voxel statistics — the tensor-program
replacement for PCL's octree / VoxelGrid machinery.

The reference uses:
  - ``pcl::VoxelGrid`` downsampling (FCCF.cpp:1377-1387, :1668-1678)
  - ``pcl::octree::OctreePointCloudSearch`` voxel occupancy + per-voxel point
    lists for plane fitting (FCCF.cpp:475-534) and fine verification
    (FCCF.cpp:792-796)

There is no tree: voxelization is a hash -> sort -> segment-reduce
program over fixed-capacity arrays. Voxel cells are anchored at the absolute
origin (``floor(p / res)``), not at the cloud bounding box like PCL's octree;
this is a deliberate, documented divergence (deterministic, batch-friendly)
that only relabels cell boundaries.

Cell index packing: cells are ordered (kz, ky, kx) with kx fastest, mirroring
PCL VoxelGrid's leaf ordering, re-indexed relative to the cloud's min
occupied cell and packed into ONE int32 sort key (see ``_cell_keys``).

Layout rules this module follows (they were measured on the accelerator
the system was first built for; ROADMAP S5 re-measures them on the GPU):
  - payloads ride the sorting network (``sort_by_key``) instead of being
    permuted by post-hoc random gathers of whole clouds;
  - no ``jnp.searchsorted`` in hot paths — it lowers to a while loop of
    binary-search rounds, each a full-width random gather;
  - scatters only where indices are unique and values small (boundary
    positions, compaction tables) — no scatter-adds of wide payloads.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.tuning import env_choice
from .sorting import cosort

# A/B override for the boundary-table implementation (see
# _kth_true_positions and utils/tuning.py); "auto" = static cost model.
_KTH_IMPL = env_choice("FCCF_KTH_IMPL", "auto", ("auto", "bsearch", "scatter"))

_SENT = jnp.iinfo(jnp.int32).max

# Packed-key extent limits (cells): z-major like PCL leaf ordering.
_XBITS, _YBITS, _ZBITS = 11, 10, 10
_XMAX, _YMAX, _ZMAX = (1 << _XBITS) - 1, (1 << _YBITS) - 1, (1 << _ZBITS) - 2


class VoxelStats(NamedTuple):
    """Per-voxel plane statistics (fixed capacity V, masked)."""

    centroid: jax.Array  # (V, 3)
    cov: jax.Array       # (V, 3, 3) normalized covariance
    count: jax.Array     # (V,) int32 points in voxel
    valid: jax.Array     # (V,) bool occupied
    overflow: jax.Array  # () bool, more voxels than capacity


def _pack_cells(cells, mask, bits=(_XBITS, _YBITS, _ZBITS)):
    """Pack integer 3-D cell indices into one int32 sort key (z-major,
    re-indexed relative to the min occupied cell); invalid points get the
    sentinel and sort last. Extent limit: 2^bx x 2^by x (2^bz - 2) cells
    (default 2047 x 1023 x 1022; the top z cell is reserved so a maxed key
    never collides with the sentinel even with extra low bits appended);
    wider clouds clip into border cells and raise the overflow flag.

    Returns (key, kmin, ovf); ``_unpack_cells(key, kmin, bits)`` inverts
    exactly.
    """
    bx, by, bz = bits
    lim = jnp.array([(1 << bx) - 1, (1 << by) - 1, (1 << bz) - 2])
    masked = jnp.where(mask[:, None], cells, _SENT)
    kmin = jnp.min(masked, axis=0)
    rel = cells - kmin
    ovf = jnp.any(mask[:, None] & (rel > lim))
    rel = jnp.clip(rel, 0, lim)
    key = (rel[..., 2] << (bx + by)) | (rel[..., 1] << bx) | rel[..., 0]
    return jnp.where(mask, key, _SENT), kmin, ovf


def _unpack_cells(key, kmin, bits=(_XBITS, _YBITS, _ZBITS)):
    """Exact elementwise inverse of ``_pack_cells`` (valid keys only):
    recovers the absolute integer cell from the packed sort key, so the
    per-segment anchor is reconstructible from the sorted key itself —
    no anchor payloads ride the sort and anchor consistency within a
    segment is exact by construction (same key => same cell)."""
    bx, by, bz = bits
    kx = key & ((1 << bx) - 1)
    ky = (key >> bx) & ((1 << by) - 1)
    kz = key >> (bx + by)
    return jnp.stack([kx, ky, kz], axis=-1) + kmin


def _cell_keys(points, mask, res):
    """Single int32 sort key per point at resolution ``res`` (see
    ``_pack_cells``); cells are absolute-anchored ``floor(p / res)``.
    Returns (key, kmin, ovf)."""
    return _pack_cells(jnp.floor(points / res).astype(jnp.int32), mask)


def sort_by_key(key, *payloads, site=None):
    """Stable co-sort of payloads by an int32 key (ops/sorting.py dispatch).

    Payloads ride the sorting network (structured data movement) instead of
    being permuted by post-hoc random gathers.
    """
    return cosort((key,), payloads, stable=True, site=site)


def _run_segments(k_s):
    """Segment ids + first flags for an already-sorted key vector."""
    first = jnp.concatenate([jnp.ones((1,), bool), k_s[1:] != k_s[:-1]])
    seg_id = jnp.cumsum(first) - 1
    return seg_id, first


def sorted_segment_reduce(values, seg, num_segments, return_start=False):
    """Sums + counts per segment for a NONDECREASING segment-id vector.

    Per-segment sums are differences of the running prefix sum (log-depth
    scan, error O(eps log N)) at segment boundaries. Boundaries come from
    two unique-index scatters of the first/last position of each run —
    NOT jnp.searchsorted, which lowers to a while loop of binary-search
    rounds with full-width gathers.

    The prefix-difference error scales with the MAGNITUDE of the running
    sum, so callers must feed O(cell-size) anchored values, never raw
    coordinates: at a 100 m scene x 280k rows the prefix reaches ~3e7
    where one f32 ulp is 2 — metre-scale noise per segment (measured on
    the heritage proxy: 0.2 m median point displacement).

    values: (N, D); seg: (N,) in [0, num_segments] (num_segments = dropped).
    Returns (sums (S, D), counts (S,) int32) and, with return_start=True,
    the per-slot run-start row index (S,) (garbage at unoccupied slots —
    mask by counts > 0) for exact per-segment anchor gathers.
    """
    n = values.shape[0]
    S = num_segments
    ps = jnp.cumsum(values, axis=0)
    idx = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), seg[1:] != seg[:-1]])
    live = seg < S
    # Segment ids are CONSECUTIVE (cumsum(first) - 1 at every call site), so
    # occupied slots are exactly [0, R) and each run ends where the next one
    # starts: ONE scatter builds the start table and the end table follows
    # elementwise (saving a second N-update scatter).
    # Index S is out of bounds for the (S,) buffer -> dropped, keeping the
    # surviving scatter indices genuinely unique.
    start = (
        jnp.zeros((S,), jnp.int32)
        .at[jnp.where(first & live, seg, S)]
        .set(idx, mode="drop", unique_indices=True)
    )
    R = jnp.sum((first & live).astype(jnp.int32))
    n_valid = jnp.sum(live.astype(jnp.int32))
    slot = jnp.arange(S, dtype=jnp.int32)
    occupied = slot < R
    nxt_start = jnp.concatenate([start[1:], jnp.zeros((1,), jnp.int32)])
    end = jnp.where(slot == R - 1, n_valid - 1, nxt_start - 1)
    end = jnp.where(occupied, end, -1)
    ps_end = jnp.where(occupied[:, None], ps[jnp.maximum(end, 0)], 0.0)
    ps_start = jnp.where(
        (occupied & (start > 0))[:, None], ps[jnp.maximum(start - 1, 0)], 0.0
    )
    sums = ps_end - ps_start
    counts = jnp.where(occupied, end - start + 1, 0)
    if return_start:
        return sums, counts, jnp.where(occupied, start, 0)
    return sums, counts


def _kth_true_positions(flag, S, impl=None):
    """pos[k] = index of the (k+1)-th True in ``flag`` (N,). Slots
    k >= count return unspecified garbage; callers mask by the returned
    count. Returns (pos (S,) int32, count () int32).

    Two implementations with identical outputs at slots < count, chosen
    by a static cost model (both shapes are static):

      - "bsearch": vectorized binary search on the inclusive cumsum —
        S * ceil(log2 N) random gathered elements; for small tables over
        big clouds (office: V=1536, N=131k).
      - "scatter": ONE S-bounded scatter of the N row indices,
        independent of table size; for tables large relative to the
        cloud (resso: V=9216 over N=74k; heritage: V=9216 over N=246k).

    The crossover weighs a gathered element at twice an update row:
    bsearch iff 2 * S * ceil(log2 N) < N. The weights come from another
    accelerator and are to be measured again on the GPU (ROADMAP S5).
    """
    n = flag.shape[0]
    if impl is None:
        impl = _KTH_IMPL
    if impl == "auto":
        impl = "bsearch" if 2 * S * max(1, int(n - 1).bit_length()) < n \
            else "scatter"
    with jax.named_scope(f"kth_{impl}"):
        return _kth_impl(flag, S, impl, n)


def _kth_impl(flag, S, impl, n):
    c = jnp.cumsum(flag.astype(jnp.int32))  # inclusive, monotone
    count = c[-1]
    if impl == "scatter":
        k = c - 1  # at True rows: 0-based rank of this True
        idx = jnp.arange(n, dtype=jnp.int32)
        # rank >= S is out of bounds for the (S,) buffer -> dropped; the
        # surviving indices (one row per rank) are genuinely unique.
        dest = jnp.where(flag, k, S)
        pos = (
            jnp.zeros((S,), jnp.int32)
            .at[dest]
            .set(idx, mode="drop", unique_indices=True)
        )
        return pos, count
    target = jnp.arange(1, S + 1, dtype=jnp.int32)
    lo = jnp.zeros((S,), jnp.int32)
    hi = jnp.full((S,), n - 1, jnp.int32)
    for _ in range(max(1, int(n - 1).bit_length())):
        mid = (lo + hi) >> 1
        go_hi = c[mid] < target
        lo = jnp.where(go_hi, mid + 1, lo)
        hi = jnp.where(go_hi, hi, mid)
    return jnp.minimum(lo, n - 1), count


def voxel_grid_downsample(points, mask, res, out_capacity=None):
    """PCL-VoxelGrid-equivalent: centroid per occupied cell.

    Mirrors FCCF.cpp:1377-1387. Returns (out_points (C,3), out_mask (C,)).
    Output order is ascending (kz, ky, kx) like PCL's leaf ordering.
    """
    n = points.shape[0]
    cap = n if out_capacity is None else out_capacity
    key, kmin, key_ovf = _cell_keys(points, mask, res)
    w = mask.astype(points.dtype)
    # Accumulate CELL-ANCHORED coordinates (|p'| < res): raw coordinates
    # through the prefix-sum reduce lose metres of precision at building
    # scale (see sorted_segment_reduce); the cell corner is re-derived
    # EXACTLY from the sorted key at each run start and added back.
    anchor = jnp.floor(points / res) * res
    v = (points - anchor) * w[:, None]
    k_s, vx, vy, vz = sort_by_key(
        key, v[:, 0], v[:, 1], v[:, 2], site="downsample"
    )
    m_s = k_s != _SENT  # invalid points carry the sentinel key
    seg_id, _ = _run_segments(k_s)
    seg = jnp.where(m_s, jnp.minimum(seg_id, cap), cap)
    sums, cnts, start = sorted_segment_reduce(
        jnp.stack([vx, vy, vz], axis=-1), seg, cap, return_start=True
    )
    anchor_s = jnp.where(
        m_s[:, None],
        _unpack_cells(jnp.where(m_s, k_s, 0), kmin).astype(points.dtype) * res,
        0.0,
    )
    occ = cnts > 0
    anchor_seg = jnp.where(occ[:, None], anchor_s[start], 0.0)
    out = sums / jnp.maximum(cnts[:, None].astype(points.dtype), 1.0)
    return out + anchor_seg, occ, key_ovf


def _segment_mean_cov(pts_anchored, anchor, seg, V):
    """One-pass per-segment mean + normalized covariance over a sorted
    segment-id vector (shared by voxel_stats and downsample_and_voxelize).

    ``pts_anchored`` are coordinates relative to a per-segment-constant
    ``anchor`` (the voxel cell corner, |p'| < cell size), so the one-pass
    identity cov = E[p'p'^T] - mu' mu'^T is computed on O(1)-magnitude
    values — no catastrophic cancellation — and needs no second pass or
    (V,3)->(N,3) mean gather.
    Anchor consistency within a segment is exact: the caller derives it
    from the same integer cell that defines the segment key. Returns
    (mean_absolute, cov, cnt); mean reconstructs as mu' + anchor, with
    the anchor gathered EXACTLY at each run's first row (summing anchor
    columns through the prefix reduce loses ~prefix_magnitude * eps —
    metre-scale at a 100 m scene, see sorted_segment_reduce).
    """
    dt = pts_anchored.dtype
    w = (seg < V).astype(dt)
    p = pts_anchored * w[:, None]
    # unique covariance entries: xx, yy, zz, xy, xz, yz
    outer6 = jnp.stack(
        [
            p[:, 0] * pts_anchored[:, 0],
            p[:, 1] * pts_anchored[:, 1],
            p[:, 2] * pts_anchored[:, 2],
            p[:, 0] * pts_anchored[:, 1],
            p[:, 0] * pts_anchored[:, 2],
            p[:, 1] * pts_anchored[:, 2],
        ],
        axis=-1,
    )
    vals = jnp.concatenate([p, outer6], axis=-1)
    sums, cnt, start = sorted_segment_reduce(vals, seg, V, return_start=True)
    occ = cnt > 0
    anchor_seg = jnp.where(occ[:, None], anchor[start], 0.0)
    cntf = jnp.maximum(cnt.astype(dt), 1.0)
    mu = sums[:, 0:3] / cntf[:, None]
    mean = mu + anchor_seg
    e = sums[:, 3:9] / cntf[:, None]
    cxx = e[:, 0] - mu[:, 0] * mu[:, 0]
    cyy = e[:, 1] - mu[:, 1] * mu[:, 1]
    czz = e[:, 2] - mu[:, 2] * mu[:, 2]
    cxy = e[:, 3] - mu[:, 0] * mu[:, 1]
    cxz = e[:, 4] - mu[:, 0] * mu[:, 2]
    cyz = e[:, 5] - mu[:, 1] * mu[:, 2]
    cov = jnp.stack(
        [
            jnp.stack([cxx, cxy, cxz], axis=-1),
            jnp.stack([cxy, cyy, cyz], axis=-1),
            jnp.stack([cxz, cyz, czz], axis=-1),
        ],
        axis=-2,
    )
    return mean, cov, cnt


def voxel_stats(points, mask, res, num_voxels):
    """Per-voxel centroid + covariance + count over fixed capacity V.

    Replaces the octree voxel loop of ``face_extrate`` (FCCF.cpp:481-534):
    every occupied cell gets its centroid and a normalized covariance
    (two-pass, numerically better than PCL's E[xx^T]-mu mu^T at identical
    semantics).

    Returns (stats, sorted_points (N,3), point_voxel_sorted (N,)): the
    input cloud re-ordered by voxel cell (payloads ride the sort network)
    and each sorted point's voxel slot (== V for dropped/invalid points).
    Callers consume the residual cloud in sorted order — point order is
    immaterial downstream (fine verify counts voxel occupancy).
    """
    V = num_voxels
    key, kmin, key_ovf = _cell_keys(points, mask, res)
    k_s, px, py, pz = sort_by_key(
        key, points[:, 0], points[:, 1], points[:, 2], site="stats"
    )
    pts_s = jnp.stack([px, py, pz], axis=-1)
    m_s = k_s != _SENT  # invalid points carry the sentinel key
    seg_id, _ = _run_segments(k_s)
    seg = jnp.where(m_s & (seg_id < V), seg_id, V)

    # Per-segment anchor (cell corner), exact from the sorted key itself.
    anchor = jnp.where(
        m_s[:, None],
        _unpack_cells(jnp.where(m_s, k_s, 0), kmin).astype(points.dtype) * res,
        0.0,
    )
    mean, cov, cnt = _segment_mean_cov(pts_s - anchor, anchor, seg, V)

    nvalid_seg = jnp.max(jnp.where(m_s, seg_id, -1)) + 1
    overflow = (nvalid_seg > V) | key_ovf

    stats = VoxelStats(
        centroid=mean,
        cov=cov,
        count=cnt,
        valid=cnt > 0,
        overflow=overflow,
    )
    return stats, pts_s, seg


def compact(valid, capacity, *payloads):
    """Stable masked compaction: pack valid entries (in order) into the
    first slots of fixed-capacity outputs.

    Returns (count, overflow, out_valid (capacity,), *out_payloads). Entries
    beyond capacity are dropped (overflow flag raised). This is the masked
    equivalent of every ``std::vector::push_back`` loop in the reference.

    The k-th output slot gathers from a source-index table built with ONE
    unique-index int32 scatter (dest[k] = position of the k-th valid
    entry); payloads are then output-sized gathers. No jnp.searchsorted
    (a while loop of gather rounds) and no payload-wide scatters.
    """
    lead = valid.ndim
    valid = valid.reshape(-1)
    L = valid.shape[0]
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    count = pos[-1] + 1
    overflow = count > capacity
    # dest == capacity is out of bounds for the (capacity,) buffer and is
    # dropped, so the surviving indices are genuinely unique.
    dest = jnp.where(valid & (pos < capacity), pos, capacity)
    src = (
        jnp.zeros((capacity,), jnp.int32)
        .at[dest]
        .set(jnp.arange(L, dtype=jnp.int32), mode="drop", unique_indices=True)
    )
    out_valid = jnp.arange(capacity) < count
    outs = []
    for p in payloads:
        p = p.reshape((L,) + p.shape[lead:])
        g = p[src]
        mask = out_valid.reshape((capacity,) + (1,) * (g.ndim - 1))
        outs.append(jnp.where(mask, g, jnp.zeros((), p.dtype)))
    return (jnp.minimum(count, capacity), overflow, out_valid, *outs)


def downsample_and_voxelize(points, mask, leaf, face_res, num_voxels,
                            wide_extent: bool = False):
    """Fused VoxelGrid downsample + feature-voxel statistics: ONE sort.

    The pipeline needs two groupings of the same cloud — leaf cells
    (``leaf``, FCCF.cpp:1377-1387) whose centroids form the downsampled
    cloud, and feature voxels (``face_res``, :475-534) over those
    centroids. When ``face_res`` is an integer multiple of ``leaf`` the
    leaf grid nests exactly inside the feature grid by construction
    (face_cell = leaf_cell // ratio), so a single two-key sort
    (face_key, leaf_within_face) yields both groupings: leaf runs are
    contiguous inside face runs. This halves the pipeline's sort volume.

    Returns (down_pts (N,3), down_mask (N,), stats: VoxelStats,
    point_voxel (N,), voxel_start (V,)) where down_pts are the leaf
    centroids in face-voxel-major order (SPARSE: each centroid sits at its
    leaf run's last row; address through down_mask), point_voxel maps each
    downsampled point to its feature-voxel slot (== V for dropped), and
    voxel_start[k] is the row of voxel k's first down point (== N for
    unoccupied slots) — consumed by faces_from_voxels' residual gate.
    """
    n = points.shape[0]
    V = num_voxels
    ratio = int(round(face_res / leaf))
    assert abs(face_res - ratio * leaf) < 1e-9 * max(face_res, 1.0), (
        "fused voxelization needs face_res to be an integer multiple of "
        "leaf; use voxel_grid_downsample + voxel_stats otherwise"
    )

    k = jnp.floor(points / leaf).astype(jnp.int32)
    fcell = jnp.floor_divide(k, ratio)
    within = k - fcell * ratio  # per-dim in [0, ratio)
    wkey = (within[..., 2] * ratio + within[..., 1]) * ratio + within[..., 0]

    # Points ride the sort in FACE-CELL-ANCHORED coordinates (p - cell
    # corner, magnitude < face_res): the anchor is per-segment-constant by
    # construction (derived from the integer cell that defines the sort
    # key) and exactly reconstructible from the sorted key, enabling the
    # one-pass covariance in _segment_mean_cov with no mean gather.
    #
    # (16-bit fixed-point payload packing was tried here and measured no
    # gain — the sort's cost was row-count-bound, not payload-width-bound
    # — so payloads stay full f32.)
    anchor_in = jnp.where(
        mask[:, None], fcell.astype(points.dtype) * face_res, 0.0
    )
    p_in = jnp.where(mask[:, None], points - anchor_in, 0.0)

    if wide_extent:
        # Two-key sort: full 2047x1023x1022-cell face extent for
        # building-scale scenes, at the cost of one extra sort operand.
        fkey, kmin, ovf = _pack_cells(fcell, mask)
        wkey_m = jnp.where(mask, wkey, _SENT)
        with jax.named_scope("fused_sort"):
            fk_s, wk_s, px, py, pz = cosort(
                (fkey, wkey_m), (p_in[:, 0], p_in[:, 1], p_in[:, 2]),
                site="fused",
            )
        m_s = fk_s != _SENT
        unpack_bits = (_XBITS, _YBITS, _ZBITS)
        leaf_first = jnp.concatenate(
            [jnp.ones((1,), bool),
             (fk_s[1:] != fk_s[:-1]) | (wk_s[1:] != wk_s[:-1])]
        )
    else:
        # ONE combined int32 sort key: the within-face leaf index rides
        # the low bits of the face-cell key, so the sort carries a single
        # key operand (face runs = high-bit transitions, leaf runs = any
        # transition). The face-cell bit budget is what remains of 31 bits
        # after the leaf index (ratio^3 values): e.g. leaf 0.1 / face 1.0
        # -> 10 within bits, 7 bits per face axis = 127 m extent at 1 m
        # voxels; wider clouds clip into border cells and flag overflow,
        # like every other capacity (set Capacities.wide_extent for more).
        bits_w = max((ratio**3 - 1).bit_length(), 1)
        bits_f = 31 - bits_w
        bz = bits_f // 3
        by = bits_f // 3
        bx = bits_f - by - bz
        fkey, kmin, ovf = _pack_cells(fcell, mask, bits=(bx, by, bz))
        ckey = jnp.where(mask, (fkey << bits_w) | wkey, _SENT)
        with jax.named_scope("fused_sort"):
            ck_s, px, py, pz = cosort(
                (ckey,), (p_in[:, 0], p_in[:, 1], p_in[:, 2]), site="fused"
            )
        m_s = ck_s != _SENT
        fk_s = ck_s >> bits_w
        unpack_bits = (bx, by, bz)
        leaf_first = jnp.concatenate(
            [jnp.ones((1,), bool), ck_s[1:] != ck_s[:-1]]
        )

    dt = points.dtype
    pts_s = jnp.stack([px, py, pz], axis=-1)  # anchored coords
    anchor_s = jnp.where(
        m_s[:, None],
        (
            _unpack_cells(
                jnp.where(m_s, fk_s, 0), kmin, bits=unpack_bits
            ).astype(dt)
            * face_res
        ),
        0.0,
    )
    face_first = jnp.concatenate([jnp.ones((1,), bool), fk_s[1:] != fk_s[:-1]])

    # ---- leaf reduce, SPARSE layout: each leaf run's stats materialize at
    # the run's LAST row (the downsampled cloud is mask-addressed, not
    # prefix-packed). This replaces the former slot-table reduce whose
    # start-table scatter (N update rows) and two (N, 7)-wide boundary
    # gathers dominated the voxelize stage; the sparse
    # form needs ONE (N, 4) gather and a cummax. Invalid (sentinel-key)
    # rows sort to the tail, so valid leaf runs tile a prefix contiguously
    # and run order — hence downstream content order — is unchanged.
    idx = jnp.arange(n, dtype=jnp.int32)
    leaf_last = jnp.concatenate([leaf_first[1:], jnp.ones((1,), bool)]) & m_s
    # start of the current run: markers are strictly increasing positions,
    # so a running max forward-fills each run's start index (row 0 is
    # always a run start).
    start_fill = jax.lax.cummax(jnp.where(leaf_first, idx, 0))
    w = m_s.astype(dt)
    ff = (face_first & m_s).astype(dt)
    vals1 = jnp.concatenate([pts_s * w[:, None], ff[:, None]], axis=-1)
    ps1 = jnp.cumsum(vals1, axis=0)
    ps_prev = jnp.where(
        (start_fill > 0)[:, None], ps1[jnp.maximum(start_fill - 1, 0)], 0.0
    )
    run = ps1 - ps_prev  # at row i: column sums over [run start, i]
    cnt_leaf = jnp.maximum((idx - start_fill + 1).astype(dt), 1.0)

    down_mask = leaf_last
    down_anchored = jnp.where(
        down_mask[:, None], run[:, 0:3] / cnt_leaf[:, None], 0.0
    )
    down_anchor = jnp.where(down_mask[:, None], anchor_s, 0.0)  # exact corner
    down_pts = down_anchored + down_anchor
    # feature-voxel id of each down point: face starts seen so far, minus 1
    # (the flag cumsum is exact in f32 below 2^24 rows)
    face_of_leaf = ps1[:, 3].astype(jnp.int32) - 1
    point_voxel = jnp.where(
        down_mask & (face_of_leaf >= 0) & (face_of_leaf < V),
        face_of_leaf,
        V,
    )
    # this leaf run contains a face-run start <=> first leaf of its voxel
    face_first_down = down_mask & (run[:, 3] > 0.5)

    # ---- feature-voxel stats over the (sparse) down points: per-voxel
    # sums are prefix-scan differences at voxel boundaries; the boundary
    # table comes from a V * log2(N) binary search, not an N-row scatter.
    # Rows between down points contribute exact zeros to the prefix sums,
    # so the sums are bit-identical to a packed-layout reduce.
    # V+1 start positions: the extra slot is the first DROPPED voxel's
    # start, clamping the last kept slot's window under overflow (without
    # it, slot V-1's prefix window would extend to row n-1 and fold the
    # dropped voxels' down points into its count/centroid/cov — the packed
    # voxel_stats path excludes them, and the two layouts must agree).
    start_full, n_faces_seen = _kth_true_positions(face_first_down, V + 1)
    start_tbl = start_full[:V]
    slot = jnp.arange(V, dtype=jnp.int32)
    R = jnp.minimum(n_faces_seen, V)
    occupied = slot < R
    p = down_anchored
    outer6 = jnp.stack(
        [
            p[:, 0] * p[:, 0],
            p[:, 1] * p[:, 1],
            p[:, 2] * p[:, 2],
            p[:, 0] * p[:, 1],
            p[:, 0] * p[:, 2],
            p[:, 1] * p[:, 2],
        ],
        axis=-1,
    )
    vals2 = jnp.concatenate(
        [p, outer6, down_mask.astype(dt)[:, None]], axis=-1
    )  # (N, 10)
    ps2 = jnp.cumsum(vals2, axis=0)
    safe_start = jnp.where(occupied, start_tbl, 0)
    nxt = jnp.concatenate([start_tbl[1:], jnp.zeros((1,), jnp.int32)])
    # Last kept slot's window ends at the row before the first dropped
    # voxel's start when > V voxels exist (overflow), else at the last row.
    last_end = jnp.where(
        n_faces_seen > V, jnp.maximum(start_full[V] - 1, 0), n - 1
    )
    end = jnp.where(slot == R - 1, last_end, jnp.maximum(nxt - 1, 0))
    end = jnp.where(occupied, end, 0)
    ps_end = jnp.where(occupied[:, None], ps2[end], 0.0)
    ps_st = jnp.where(
        (occupied & (safe_start > 0))[:, None],
        ps2[jnp.maximum(safe_start - 1, 0)],
        0.0,
    )
    sums2 = ps_end - ps_st
    cnt = jnp.where(occupied, sums2[:, 9].astype(jnp.int32), 0)
    cntf = jnp.maximum(cnt.astype(dt), 1.0)
    mu = sums2[:, 0:3] / cntf[:, None]
    # per-voxel anchor: exact cell corner read at the voxel's first down row
    anchor_face = jnp.where(occupied[:, None], anchor_s[safe_start], 0.0)
    mean = mu + anchor_face
    e = sums2[:, 3:9] / cntf[:, None]
    cxx = e[:, 0] - mu[:, 0] * mu[:, 0]
    cyy = e[:, 1] - mu[:, 1] * mu[:, 1]
    czz = e[:, 2] - mu[:, 2] * mu[:, 2]
    cxy = e[:, 3] - mu[:, 0] * mu[:, 1]
    cxz = e[:, 4] - mu[:, 0] * mu[:, 2]
    cyz = e[:, 5] - mu[:, 1] * mu[:, 2]
    cov = jnp.stack(
        [
            jnp.stack([cxx, cxy, cxz], axis=-1),
            jnp.stack([cxy, cyy, cyz], axis=-1),
            jnp.stack([cxz, cyz, czz], axis=-1),
        ],
        axis=-2,
    )

    overflow = (n_faces_seen > V) | ovf
    stats = VoxelStats(
        centroid=mean, cov=cov, count=cnt, valid=cnt > 0, overflow=overflow
    )
    voxel_start = jnp.where(occupied, start_tbl, n)
    return down_pts, down_mask, stats, point_voxel, voxel_start

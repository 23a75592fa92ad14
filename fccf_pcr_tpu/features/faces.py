"""Planar-face extraction: voxel plane fits + parallel region growing.

Tensor redesign of ``face_extrate`` (FCCF.cpp:470-678, component C10):

  reference (sequential, order-dependent)      this module (parallel, masked)
  -----------------------------------------    -------------------------------
  octree voxel loop + computePointNormal       hash/segment voxel_stats +
    (FCCF.cpp:481-534)                           batched 3x3 eigendecomp
  greedy voxel->face growth w/ running         voxel-voxel affinity matrix +
    averages (FCCF.cpp:536-593)                  min-label propagation
  face<->face merge to fixpoint                face-face affinity + second
    (FCCF.cpp:595-648)                           label propagation
  selection sort + top-15(+1) + roughness      masked lexsort + segment means
    (FCCF.cpp:650-677)

Semantics note (SURVEY.md hard part #1): the reference's growth tests each
candidate voxel against the *running average* of the growing face, so its
result depends on iteration order. Label propagation instead computes
connected components of the symmetric voxel-voxel affinity built from the
same predicates (compare_normal / compare_plane on per-voxel stats). Face
*statistics* for a given membership are identical (the reference recomputes
full weighted sums after every insertion, FCCF.cpp:570-586); only membership
can differ on borderline scenes. Parity is defined at the output-transform
level (RTE/RRE), not the face-set level.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Capacities, FCCFParams
from ..ops import eigen3, geometry
from ..ops.pallas import label_prop
from ..ops.voxelize import compact, voxel_stats
from ..utils.tuning import env_int

_BIG = np.int32(2**30)


class Faces(NamedTuple):
    """Fixed-capacity (F=16) planar faces, masked. Mirrors ``facenode``
    (FCCF.cpp:47-58): centroid/normal are point-count-weighted averages of
    member voxel stats; ``normal`` is intentionally NOT renormalized (the
    reference never renormalizes it, and downstream math consumes the raw
    averaged vector)."""

    centroid: jax.Array     # (F, 3)
    normal: jax.Array       # (F, 3) weighted-average normal (non-unit)
    point_size: jax.Array   # (F,) float  sum of member voxel point counts
    voxel_count: jax.Array  # (F,) int32  member voxels (sort key, :417)
    theta: jax.Array        # (F,) roughness = mean |angle(face n, voxel n)|
    valid: jax.Array        # (F,) bool


def _pairwise_affinity(normal, centroid, valid, angle_thresh_deg, l, k):
    """(V, V) boolean affinity from compare_normal & compare_plane.

    Built with (V,3)x(3,V) matmuls so no (V,V,3) intermediate materializes.
    """
    nh = geometry.normalize(normal)
    cos_gate = jnp.cos(jnp.deg2rad(angle_thresh_deg)).astype(normal.dtype)
    cosmat = nh @ nh.T
    ok_normal = cosmat >= cos_gate

    c2 = jnp.sum(centroid * centroid, axis=-1)
    d2 = c2[:, None] + c2[None, :] - 2.0 * (centroid @ centroid.T)
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    # n_i . (c_i - c_j)  and  n_j . (c_i - c_j). Like the reference's
    # compare_plane (:391-407), the *raw* (possibly non-unit averaged)
    # normal is used here; only the direction vector is normalized.
    ndotc = jnp.sum(normal * centroid, axis=-1)
    m1 = ndotc[:, None] - normal @ centroid.T
    m2 = centroid @ normal.T - ndotc[None, :]
    t = l / (k * dist + 1.0)
    ok_plane = (jnp.abs(m1) < t * dist) & (jnp.abs(m2) < t * dist)
    ok_plane = jnp.where(dist > 1e-9, ok_plane, True)

    vv = valid[:, None] & valid[None, :]
    return vv & ok_normal & ok_plane


def _label_components(normal, centroid, valid, angle_thresh, l, k, params,
                      bound=None):
    """Connected-component min labels of the affinity graph.

    On the GPU this is the fused Pallas kernel (ops/pallas/label_prop.py):
    predicates computed in registers, sweeps cut to the occupied prefix
    ``bound``, no (V, V) array in device memory. Every other backend runs
    the plain affinity-matrix path below, which is also the kernel's
    reference; both reach the same fixpoint.

    ``bound`` (traced int32): upper bound on valid slot indices (occupied
    prefix length). Only the kernel reads it; the plain path's sweeps are
    full fixed-shape (V, V) reductions either way.
    """
    if jax.default_backend() == "gpu":
        return label_prop.label_propagate(
            normal, centroid, valid, angle_thresh, l, k, bound=bound,
            max_iters=params.label_prop_iters,
        )
    aff = _pairwise_affinity(normal, centroid, valid, angle_thresh, l, k)
    return _label_propagate(aff, valid, params.label_prop_iters)


def pointer_jump(labels, V, rounds: int = 8):
    """Path-halving: labels <- min(labels, labels[labels]) a few times.

    After a neighbor-min sweep, chains shrink by one hop per sweep; pointer
    jumping shortcuts them exponentially with O(V) gathers, so only ~2-4
    expensive O(V^2) sweeps are needed regardless of component diameter.
    Invariant preserved: labels[i] is always the index of some node in i's
    component with labels monotonically decreasing toward the component min.
    """
    def body(_, l):
        return jnp.minimum(l, l[jnp.minimum(l, V - 1)])

    return jax.lax.fori_loop(0, rounds, body, labels)


def _label_propagate(affinity, valid, max_iters):
    """Connected components by min-label propagation + pointer jumping.

    labels[i] converges to the minimum slot index of i's component. Each
    iteration does one O(V^2) neighbor-min sweep over the affinity matrix
    followed by O(V) path-halving rounds.
    """
    V = affinity.shape[0]
    init = jnp.where(valid, jnp.arange(V, dtype=jnp.int32), _BIG)

    def cond(state):
        labels, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        labels, _, it = state
        neigh = jnp.min(jnp.where(affinity, labels[None, :], _BIG), axis=1)
        new = jnp.minimum(labels, neigh)
        new = jnp.where(valid, pointer_jump(new, V), _BIG)
        return new, jnp.any(new != labels), it + 1

    labels, _, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True), 0))
    return labels


# One-hot face-stats matmuls materialize a (V, V) f32 in device memory
# (~340 MB per cloud at the heritage preset's V=9216); the scatter-add
# form is update-row-bound and touches only (V, D). Selected per call by V
# so small presets keep the matmul path. The threshold is off until it is
# measured on the GPU (ROADMAP D2); FCCF_SCATTER_STATS_MIN_V overrides it
# per process.
_SCATTER_STATS_MIN_V = env_int("FCCF_SCATTER_STATS_MIN_V", 1 << 30)


def _label_segment_sum(values, labels, valid, V, impl=None):
    """Per-label sums of ``values`` ((V,) or (V, D)) over arbitrary
    slot-index labels (component min-index) — the unsorted segment
    reduction shared by _face_stats and the theta roughness reduce, so
    both always pick the SAME implementation (the one-hot expressions CSE
    into one (V, V) materialization per label set). Two implementations,
    identical up to f32 summation order:

      - "onehot": (V, V) x (V, D) one-hot matrix product — few FLOPs at
        V <= 8192, but the one-hot materializes (V, V) f32 in device
        memory, which grows quadratically with the preset's V;
      - "scatter": one V-row scatter-add — update-row-bound, no
        quadratic intermediate; for building-scale V.

    Rows with valid=False contribute nothing. ``impl=None`` selects by V
    (see _SCATTER_STATS_MIN_V)."""
    if impl is None:
        impl = "scatter" if V >= _SCATTER_STATS_MIN_V else "onehot"
    vals2d = values if values.ndim == 2 else values[:, None]
    dt = vals2d.dtype
    if impl == "scatter":
        # Invalid rows scatter to index V -> out of bounds -> dropped.
        seg = jnp.where(valid, jnp.minimum(labels, V - 1), V)
        sums = (
            jnp.zeros((V, vals2d.shape[1]), dt)
            .at[seg]
            .add(jnp.where(valid[:, None], vals2d, 0.0), mode="drop")
        )
    else:
        seg = jnp.where(valid, jnp.minimum(labels, V - 1), V - 1)
        onehot = (
            (seg[:, None] == jnp.arange(V)[None, :]) & valid[:, None]
        ).astype(dt)  # (voxel, face-slot)
        sums = onehot.T @ vals2d
    return sums if values.ndim == 2 else sums[:, 0]


def _face_stats(labels, valid, count, centroid, normal, V, impl=None):
    """Weighted segment stats per face label (identical math to the
    reference's full recomputation loops, FCCF.cpp:570-586/:626-642).
    Reduction via _label_segment_sum (implementation chosen by V)."""
    dt = centroid.dtype
    w = jnp.where(valid, count.astype(dt), 0.0)
    stats = jnp.concatenate(
        [
            centroid * w[:, None],
            normal * w[:, None],
            w[:, None],
            jnp.ones_like(w[:, None]),
        ],
        axis=-1,
    )  # (V, 8)
    sums = _label_segment_sum(stats, labels, valid, V, impl=impl)
    csum, nsum = sums[:, 0:3], sums[:, 3:6]
    psize = sums[:, 6]
    vcount = jnp.round(sums[:, 7]).astype(jnp.int32)
    denom = jnp.maximum(psize, 1e-12)[:, None]
    return csum / denom, nsum / denom, psize, vcount


def extract_faces(points, mask, params: FCCFParams, caps: Capacities):
    """points (N,3), mask (N,) -> (Faces, (sorted_pts, residual_mask), ovf).

    Standalone path: voxelizes ``points`` at ``face_voxel_size`` itself.
    The pipeline driver uses ``downsample_and_voxelize`` (one fused sort)
    and calls :func:`faces_from_voxels` directly.
    """
    vs, sorted_pts, point_voxel = voxel_stats(
        points, mask, params.face_voxel_size, caps.max_voxels
    )
    return faces_from_voxels(vs, sorted_pts, point_voxel, params, caps)


def voxel_planes(vs, cloud_pts, point_voxel, params):
    """Per-voxel plane fits (FCCF.cpp:481-516): the normal, oriented
    toward the cloud's centroid, and the point-count and curvature gates.
    Returns (normal, enough, planar)."""
    V = vs.count.shape[0]
    cloud_mask = point_voxel < V
    total = jnp.sum(cloud_mask.astype(cloud_pts.dtype))
    global_centroid = jnp.sum(
        jnp.where(cloud_mask[:, None], cloud_pts, 0.0), axis=0
    ) / jnp.maximum(total, 1.0)

    normal, curvature = eigen3.plane_fit_from_cov(vs.cov)

    enough = vs.count > params.voxel_point_threshold  # strictly > (:486)
    planar = curvature < params.curvature_threshold   # (:497)

    # Orient each normal so it points toward the global centroid (:504-516).
    to_c = vs.centroid - global_centroid[None, :]
    flip = jnp.sum(to_c * normal, axis=-1) < 0.0
    normal = jnp.where(flip[:, None], normal, -normal)
    return normal, enough, planar


def faces_from_voxels(vs, cloud_pts, point_voxel, params, caps,
                      with_labels: bool = False, voxel_start=None):
    """Face growth + selection from per-voxel stats.

    ``cloud_pts`` is the (voxel-ordered) cloud with ``point_voxel`` mapping
    each point to its voxel slot (== V when dropped). The residual pair
    marks points belonging to voxels that passed the point-count gate but
    failed the curvature gate — the reference's ``cloud_sub``
    (FCCF.cpp:527-530), consumed by fine verification (order-insensitive).

    with_labels=True additionally returns (final_label, vvalid, order,
    fvalid): the per-voxel-slot face label (component min slot index), the
    planar gate, and the top-F selection (order[k] = label slot of face
    row k) — consumed by the twin face-membership diff tool
    (twin/diff.py), not by the production pipeline.
    """
    V = caps.max_voxels
    F = caps.max_faces

    normal, enough, planar = voxel_planes(vs, cloud_pts, point_voxel, params)
    vvalid = vs.valid & enough & planar

    # Residual (non-planar) cloud mask for fine verify (:527-530), aligned
    # to sorted_pts. Points in under-populated voxels are dropped entirely,
    # matching the reference. Gather-free expansion of the per-voxel gate to
    # the (voxel-sorted) points: voxel slots are consecutive, so each run's
    # start position is the exclusive cumsum of the per-voxel counts; a
    # V-update scatter plants a packed (2*start_pos + gate) marker at each
    # run start and one cummax forward-fills it — run starts are strictly
    # increasing, so later markers always win. (This replaces an N-update
    # first-position scatter and a (V,)->(N,) gather.)
    residual_gate = vs.valid & enough & ~planar
    N = point_voxel.shape[0]
    if voxel_start is not None:
        # Sparse cloud layout (downsample_and_voxelize): run starts come
        # from the precomputed table, not from count prefix sums.
        start_v = voxel_start
    else:
        # Packed layout (voxel_stats): voxel runs tile the prefix, so run
        # k starts at the exclusive cumsum of the per-voxel counts.
        start_v = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(vs.count)[:-1]]
        ).astype(jnp.int32)
    marker = (
        jnp.zeros((N,), jnp.int32)
        .at[jnp.where(vs.valid, start_v, N)]
        .set(
            start_v * 2 + residual_gate.astype(jnp.int32),
            mode="drop",
            unique_indices=True,
        )
    )
    gate_pt = (jax.lax.cummax(marker) & 1) == 1
    residual_mask = gate_pt & (point_voxel < V)

    # Pass 1: voxel -> face growth (compare_normal 5deg, l1/k1) (:536-593).
    # Occupied voxel slots are prefix-compacted (consecutive seg ids from
    # the sorted keys), so the max planar slot bounds the kernel's sweep
    # work at runtime.
    n_occ = jnp.max(jnp.where(vvalid, jnp.arange(V, dtype=jnp.int32), -1)) + 1
    with jax.named_scope("label_prop1"):
        labels1 = _label_components(
            normal, vs.centroid, vvalid, params.normal_thresh1, params.l1,
            params.k1, params, bound=n_occ,
        )

    with jax.named_scope("face_stats1"):
        c1, n1, p1, vc1 = _face_stats(
            labels1, vvalid, vs.count, vs.centroid, normal, V
        )
    rep1 = vvalid & (labels1 == jnp.arange(V))

    # Pass 2: face <-> face merge to fixpoint (compare_normal 8deg, l2/k2)
    # (:595-648). Same propagation primitive over face-representative
    # slots — but representatives are SCATTERED component-min slots, only
    # a few hundred of them, so they are compacted to a slot prefix first
    # and the merge propagation runs at n_reps^2 (not V^2) sweep cost.
    # Compaction is stable (order-preserving), so the component-min
    # compact index maps back to the component-min slot index: labels are
    # bit-identical to running the propagation in slot space.
    with jax.named_scope("label_prop2"):
        n_reps, _, cvalid, c_n1, c_c1, slot_of = compact(
            rep1, V, n1, c1, jnp.arange(V, dtype=jnp.int32)
        )
        labels2_c = _label_components(
            c_n1, c_c1, cvalid, params.normal_thresh2, params.l2, params.k2,
            params, bound=n_reps,
        )
        comp_of_slot = jnp.cumsum(rep1.astype(jnp.int32)) - 1
        lbl_c = labels2_c[jnp.clip(comp_of_slot, 0, V - 1)]
        labels2 = jnp.where(rep1, slot_of[jnp.minimum(lbl_c, V - 1)], _BIG)

    final_label = jnp.where(vvalid, labels2[jnp.minimum(labels1, V - 1)], _BIG)
    with jax.named_scope("face_statsF"):
        cF, nF, pF, vcF = _face_stats(
            final_label, vvalid, vs.count, vs.centroid, normal, V
        )
    repF = vvalid & (final_label == jnp.arange(V))

    # Per-voxel angle to its face's average normal -> per-face roughness
    # theta (:660-667). Same reduce (and impl) as _face_stats — on the
    # one-hot path the expression CSEs with the final _face_stats call's
    # one-hot, so it costs no extra (V, V) materialization.
    fl = jnp.minimum(final_label, V - 1)
    ang = jnp.where(vvalid, jnp.abs(geometry.angle_deg(nF[fl], normal)), 0.0)
    asum = _label_segment_sum(ang, final_label, vvalid, V)
    theta = asum / jnp.maximum(vcF.astype(cloud_pts.dtype), 1.0)

    # Top-16 faces by member-voxel count, desc; ties by slot index asc
    # (range_face :409-427 swaps only on strict <, i.e. stable).
    sort_key = jnp.where(repF, vcF, -1)
    order = jnp.lexsort((jnp.arange(V), -sort_key))[:F]
    fvalid = sort_key[order] > 0

    faces = Faces(
        centroid=jnp.where(fvalid[:, None], cF[order], 0.0),
        normal=jnp.where(fvalid[:, None], nF[order], 0.0),
        point_size=jnp.where(fvalid, pF[order], 0.0),
        voxel_count=jnp.where(fvalid, vcF[order], 0),
        theta=jnp.where(fvalid, theta[order], 0.0),
        valid=fvalid,
    )
    if with_labels:
        return faces, (cloud_pts, residual_mask), vs.overflow, (
            final_label, vvalid, order, fvalid
        )
    return faces, (cloud_pts, residual_mask), vs.overflow

"""End-to-end scan-pair registration — the pipeline driver.

Rebuild of ``computer_transform_guess`` (FCCF.cpp:1370-1608, C18) as a single
jit-compilable function of fixed-shape masked tensors, plus batched/vmapped
entry points.

Direction convention: ``register_pair(src, tar)`` returns T mapping the
SOURCE cloud into the TARGET frame. Internally the *target* cloud plays the
reference's ``face_vecter1`` role and the source plays ``face_vecter2`` —
this mirrors the reference's argument swap at the call site
(``computer_transform_guess(cloud_tar, cloud_src, T)``, FCCF.cpp:1683),
which is what makes its printed matrix map argv[1] (source) into argv[2]
(target).

Stage map (all stages live in their own modules):
  NaN removal + voxel-grid downsample  (:1372-1387)  -> ops.voxelize
  face extraction x2                   (:1400-1401)  -> features.faces
  base selection x2                    (:1406-1409)  -> hypotheses.bases
  base matching + closed-form fan-out  (:1414-1427)  -> hypotheses.transforms
  per-type clustering                  (:1437-1466)  -> cluster.cluster
  quick verify + refine per rep        (:1468-1494)  -> verify.quick, refine
  fine verify top-4 per type           (:1499-1544)  -> verify.fine
  combined score + 0.8 gate + fusion   (:1546-1606)  -> fuse.fuse
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..cluster.cluster import cluster_hypotheses
from ..config import Capacities, FCCFParams
from ..features.faces import extract_faces, faces_from_voxels
from ..fuse.fuse import fuse_transforms
from ..hypotheses.bases import select_bases
from ..hypotheses.transforms import generate_hypotheses
from ..ops import geometry
from ..ops.voxelize import (
    compact,
    downsample_and_voxelize,
    voxel_grid_downsample,
)
from ..verify.fine import build_source_table, fine_verify
from ..verify.quick import match_faces, refine_transform

# Status bit flags (the replacement for the reference's silent
# degradation; see SURVEY.md section 5, failure detection row).
STATUS_OK = 0
STATUS_VOXEL_OVERFLOW = 1
STATUS_HYPOTHESIS_OVERFLOW = 2
STATUS_DEGENERATE = 4  # no type scored > 0: identity returned
STATUS_REP_OVERFLOW = 8       # cluster seed/representative capacity exceeded
STATUS_RESIDUAL_OVERFLOW = 16  # residual cloud truncated to max_residual
# NOTE on vocabulary: the fine-verify TABLE cloud (verify/fine.py's
# "source", the reference's cloud_sub1) is THIS pipeline's *target*
# residual — register_pair swaps roles at the call site like the
# reference does (see module docstring). The two bits below are about
# the table cloud, i.e. the TARGET residual.
STATUS_FINE_OVERFLOW = 32      # fine-verify table > max_fine_voxels voxels
STATUS_FINE_ALIAS = 64  # fine-verify TABLE-cloud span > 1024 cells/axis:
#   the table's wrapped keys may have merged distinct voxels (candidate
#   poses can't alias — out-of-window probe cells are dropped from the
#   join, verify/fine.py)


class RegistrationResult(NamedTuple):
    transform: jax.Array     # (4, 4) source -> target
    quick_score: jax.Array   # (3,) best combined quick score per type
    fine_score: jax.Array    # (3,)
    n_faces: jax.Array       # (2,) int32 faces in target/source clouds
    n_hypotheses: jax.Array  # () int32
    status: jax.Array        # () int32 bit flags
    # Observability (SURVEY.md §5): the per-type winners entering fusion.
    type_transform: jax.Array  # (3, 4, 4) per-type best refined transform
    type_score: jax.Array      # (3,) combined score of each winner
    kept: jax.Array            # (3,) bool, passed the 0.8 fusion gate


def register_pair(
    src_pts, src_mask, tar_pts, tar_mask, params: FCCFParams, caps: Capacities
) -> RegistrationResult:
    """Register one masked pair of clouds. Inputs (N, 3) + (N,) masks.

    Expects clouds already voxel-grid downsampled once by the caller (the
    reference downsamples in main AND again inside the pipeline,
    FCCF.cpp:1668-1678 + :1377-1387 — this function performs the second,
    internal downsample).

    All matmuls run at full float32 precision (no TF32): the pipeline's
    dots are K=3 geometry contractions and boolean-mask reductions
    (bandwidth-bound, so full precision is ~free), while a reduced
    precision mode injects ~1e-3 relative noise — enough to flip the
    cos-threshold predicates (cos 5 deg = 0.9962) and degrade RRE.
    """
    with jax.default_matmul_precision("highest"):
        return _register_pair_impl(
            src_pts, src_mask, tar_pts, tar_mask, params, caps
        )


def _register_pair_impl(
    src_pts, src_mask, tar_pts, tar_mask, params: FCCFParams, caps: Capacities
) -> RegistrationResult:
    f32 = src_pts.dtype

    # NaN removal (:1372-1375) + internal downsample (:1377-1387), fused
    # with the feature voxelization (one sort per cloud) when the leaf
    # nests integrally inside the feature voxel — true for all presets.
    ratio = params.face_voxel_size / params.leaf_size
    fused = abs(ratio - round(ratio)) < 1e-9 * max(ratio, 1.0)

    with jax.named_scope("downsample"):
        src_mask = src_mask & jnp.all(jnp.isfinite(src_pts), axis=-1)
        tar_mask = tar_mask & jnp.all(jnp.isfinite(tar_pts), axis=-1)
        src_pts = jnp.where(src_mask[:, None], src_pts, 0.0)
        tar_pts = jnp.where(tar_mask[:, None], tar_pts, 0.0)

    # Faces: f1 = target cloud (reference's face_vecter1), f2 = source.
    with jax.named_scope("faces"):
        if fused:
            def cloud_to_faces(pts, msk):
                d, dm, vs, pv, vstart = downsample_and_voxelize(
                    pts, msk, params.leaf_size, params.face_voxel_size,
                    caps.max_voxels, wide_extent=caps.wide_extent,
                )
                return faces_from_voxels(
                    vs, d, pv, params, caps, voxel_start=vstart
                )
        else:
            def cloud_to_faces(pts, msk):
                d, dm, d_ovf = voxel_grid_downsample(pts, msk, params.leaf_size)
                faces, residual, f_ovf = extract_faces(d, dm, params, caps)
                return faces, residual, f_ovf | d_ovf

        f1, (res1_pts, res1_mask), ovf1 = cloud_to_faces(tar_pts, tar_mask)
        f2, (res2_pts, res2_mask), ovf2 = cloud_to_faces(src_pts, src_mask)

    with jax.named_scope("hypotheses"):
        b1 = select_bases(f1, params)
        b2 = select_bases(f2, params)
        hyp = generate_hypotheses(f1, f2, b1, b2, params, caps)
    with jax.named_scope("cluster"):
        reps = cluster_hypotheses(hyp, params, caps)

    # Quick verify every representative (3 types x C reps). Scores are
    # refinement-independent (see verify.quick.match_faces), so the LM
    # refinement is deferred to the top candidates actually consumed.
    with jax.named_scope("quick_verify"):
        rep_T = geometry.make_transform(
            geometry.quat_to_matrix(reps.quat), reps.t
        )
        mv = jax.vmap(jax.vmap(lambda T: match_faces(T, f1, f2, params)[0]))
        qscore = jnp.where(reps.valid, mv(rep_T), -jnp.inf)

    # Per-type sort by quick score desc (score_range :1233-1251, stable) and
    # select the top fine_verify_number for fine verification (:1499-1544).
    K = params.fine_verify_number
    order = jnp.argsort(-qscore, axis=1, stable=True)  # desc, ties keep order
    top_idx = order[:, :K]                                # (3, K)
    top_valid = jnp.take_along_axis(reps.valid, top_idx, axis=1)
    top_T0 = jnp.take_along_axis(rep_T, top_idx[..., None, None], axis=1)
    top_q = jnp.take_along_axis(qscore, top_idx, axis=1)
    top_q = jnp.where(top_valid, top_q, 0.0)

    # Refine only the (3, K) selected candidates (:772-776 semantics).
    with jax.named_scope("refine"):
        rv = jax.vmap(jax.vmap(lambda T: refine_transform(T, f1, f2, params)))
        top_T = rv(top_T0)

    # Fine verify: residual clouds (cloud_sub1 = target residual, label 0;
    # cloud_sub2 = source residual, label 1, transformed per candidate).
    with jax.named_scope("fine_verify"):
        _, r1_ovf, r1_valid, r1_pts = compact(
            res1_mask, caps.max_residual, res1_pts
        )
        _, r2_ovf, r2_valid, r2_pts = compact(
            res2_mask, caps.max_residual, res2_pts
        )
        table = build_source_table(r1_pts, r1_valid, params, caps)
        fv = jax.vmap(
            lambda T: fine_verify(T, table, r2_pts, r2_valid, params, caps)
        )
        # Only the refined pose is fine-verified, the reference's order
        # (refine, then fine-verify, FCCF.cpp:772-776 + :1538). A
        # "keep the better of pre/post-refine by fine score" guard was
        # built, measured, and DELETED round 5: under the 0.005
        # curvature gate it degraded every accuracy metric on both
        # measured families (structured RTE p95 0.077->0.153 m, RRE p95
        # 0.112->0.156 deg; heritage RTE p95 0.121->0.166 m; 40-seed
        # A/B) — docs/PARITY.md divergence 8.
        fscore_flat, falias_flat = fv(top_T.reshape(3 * K, 4, 4))
        fscore = jnp.where(top_valid, fscore_flat.reshape(3, K), 0.0)
        fine_aliased = jnp.any(falias_flat.reshape(3, K) & top_valid)

    # Global score normalization across ALL fine-verified candidates of all
    # types (:1539-1540 accumulate across the type loop), then per-type best
    # by combined score (:1553-1567).
    s1_sum = jnp.sum(top_q)
    s2_sum = jnp.sum(fscore)
    combined = jnp.where(s1_sum > 0, top_q / jnp.maximum(s1_sum, 1e-20), 0.0)
    combined = combined + jnp.where(
        s2_sum > 0, fscore / jnp.maximum(s2_sum, 1e-20), 0.0
    )
    combined = jnp.where(top_valid, combined, 0.0)

    best_in_type = jnp.argmax(combined, axis=1)            # first max (:1559 >)
    best_score = jnp.take_along_axis(combined, best_in_type[:, None], axis=1)[:, 0]
    best_T = jnp.take_along_axis(
        top_T, best_in_type[:, None, None, None], axis=1
    )[:, 0]
    best_best = jnp.max(best_score)

    # 0.8 gate (:1600-1605) + weighted fusion (:1606).
    keep = best_score > params.fuse_gate * best_best
    if params.fuse_rotation_gate_deg > 0:
        # rotation-consistency gate (default on at 10 deg, see
        # FCCFParams.fuse_rotation_gate_deg): kept types must agree with
        # the best type's rotation; 0 restores the reference's blind
        # average.
        best_type = jnp.argmax(best_score)
        rel = geometry.rotation_error_deg(
            best_T[:, :3, :3], best_T[best_type, :3, :3][None]
        )
        keep = keep & (rel < params.fuse_rotation_gate_deg)
    quats = geometry.matrix_to_quat(best_T[:, :3, :3])
    T = fuse_transforms(quats, best_T[:, :3, 3], best_score, keep)

    degenerate = best_best <= 0.0
    T = jnp.where(degenerate, jnp.eye(4, dtype=f32), T)

    status = (
        jnp.where(ovf1 | ovf2, STATUS_VOXEL_OVERFLOW, 0)
        | jnp.where(hyp.overflow, STATUS_HYPOTHESIS_OVERFLOW, 0)
        | jnp.where(degenerate, STATUS_DEGENERATE, 0)
        | jnp.where(reps.overflow, STATUS_REP_OVERFLOW, 0)
        | jnp.where(r1_ovf | r2_ovf, STATUS_RESIDUAL_OVERFLOW, 0)
        | jnp.where(table.overflow, STATUS_FINE_OVERFLOW, 0)
        | jnp.where(fine_aliased, STATUS_FINE_ALIAS, 0)
    ).astype(jnp.int32)

    return RegistrationResult(
        transform=T,
        quick_score=jnp.max(top_q, axis=1),
        fine_score=jnp.max(fscore, axis=1),
        n_faces=jnp.stack(
            [jnp.sum(f1.valid), jnp.sum(f2.valid)]
        ).astype(jnp.int32),
        n_hypotheses=hyp.count,
        status=status,
        type_transform=best_T,
        type_score=best_score,
        kept=keep,
    )


def pre_downsample(points, mask, params: FCCFParams, caps: Capacities):
    """CLI-level first voxel-grid pass (FCCF.cpp:1668-1678).

    The reference runs this in ``main`` BEFORE its clock starts
    (:1681-1685), then the pipeline re-downsamples internally
    (:1377-1387). Mirroring that boundary, this helper takes a raw-capacity
    cloud (``caps.raw_points`` entries) and produces the compacted
    ``caps.max_points`` cloud the hot registration step consumes — so the
    pipeline's sort volume is sized to post-downsample content, not raw
    padding. Returns (pts, mask, overflow).
    """
    d, dm, ovf = voxel_grid_downsample(points, mask, params.leaf_size)
    _, ovf2, out_valid, out_pts = compact(dm, caps.max_points, d)
    return out_pts, out_valid, ovf | ovf2


def make_register_fn(params: FCCFParams, caps: Capacities, batched: bool = False):
    """Build a jitted registration function with static params/capacities.

    batched=False: (src (N,3), src_mask, tar (N,3), tar_mask) -> result
    batched=True:  adds a leading pair axis on every argument (vmap).
    """
    fn = functools.partial(register_pair, params=params, caps=caps)
    if batched:
        fn = jax.vmap(fn)
    return jax.jit(fn)

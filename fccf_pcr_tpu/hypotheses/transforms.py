"""Closed-form rigid-transform hypothesis generation.

Rebuild of the base-matching loop (FCCF.cpp:1414-1427) and
``computer_transform`` (FCCF.cpp:841-1018, C13) as one batched tensor
program:

  1. (B1 x B2) compatibility mask: |included-angle difference| < 5 deg and
     same roughness type (:1420) -> compacted to M matched base pairs.
  2. Per match: closed-form R = R2*R1 aligning the target base planes onto
     the source base planes (:848-895).
  3. Per match: third-plane fan-out — every source face s with
     |(n1 x m1)^ . n_s| > 0.5 (:906-927) crossed with every target face t
     whose rotated normal matches n_s within 5 deg and spans (:950-958) —
     each (s, t) yields a translation from the 3-plane offset solve
     A T = D (:969-987). No hit -> fallback translation between
     size-weighted base centroids (:1000-1017).
  4. All hypotheses (quaternion + translation + type) are compacted to a
     fixed capacity H in the exact enumeration order of the reference
     (b1-major, b2, then s, then t, fallback last).

Reference quirks preserved: raw (non-unit averaged) face normals feed every
dot product; d22 pairs the *untransformed* target centroid with the
*R1-rotated* m2 (:973 — m2 was overwritten at :870); the A-matrix rows are
the raw source normals.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import Capacities, FCCFParams
from ..features.faces import Faces
from ..ops import geometry
from ..ops.voxelize import compact
from .bases import Bases


class Hypotheses(NamedTuple):
    quat: jax.Array    # (H, 4) w,x,y,z
    t: jax.Array       # (H, 3)
    type_: jax.Array   # (H,) int32 in {0,1,2}
    valid: jax.Array   # (H,) bool
    count: jax.Array   # () int32 total valid (pre-overflow)
    overflow: jax.Array  # () bool


def _inv3x3(A):
    """Batched 3x3 inverse via adjugate (matches Eigen's .inverse() for
    small fixed-size matrices)."""
    a = A[..., 0, 0]; b = A[..., 0, 1]; c = A[..., 0, 2]
    d = A[..., 1, 0]; e = A[..., 1, 1]; f = A[..., 1, 2]
    g = A[..., 2, 0]; h = A[..., 2, 1]; i = A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    det = jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], axis=-1),
            jnp.stack([co10, co11, co12], axis=-1),
            jnp.stack([co20, co21, co22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _match_one(f1: Faces, f2: Faces, i1, j1, i2, j2, params: FCCFParams):
    """One matched base pair -> (quat, (Fs,Ft) translations+mask, fallback).

    Vectorized body of ``computer_transform`` for a single (base1, base2)
    match; vmapped over the M compacted matches by the caller.
    """
    F = f1.valid.shape[0]
    n1 = f1.normal[i1]
    m1 = f1.normal[j1]
    n2 = f2.normal[i2]
    m2 = f2.normal[j2]

    R, m2r = geometry.rotation_between_planes(n1, m1, n2, m2)

    # Third source planes (:906-927): normalized n1 x m1 against raw n_s.
    n1cm1 = geometry.normalize(jnp.cross(n1, m1))
    span_s = jnp.abs(f1.normal @ n1cm1)
    src_ok = (
        f1.valid
        & (span_s > params.third_plane_threshold)
        & (jnp.arange(F) != i1)
        & (jnp.arange(F) != j1)
    )

    # Rotated target face normals/centroids (:936-948, pure rotation — the
    # translation column is still zero at this point in the reference).
    nt_r = f2.normal @ R.T
    ct_r = f2.centroid @ R.T
    n2cm2 = geometry.normalize(jnp.cross(n2, m2r))  # quirk: rotated m2 (:930)
    tar_ok = (
        f2.valid
        & (jnp.abs(nt_r @ n2cm2) > params.third_plane_threshold)
        & (jnp.arange(F) != i2)
        & (jnp.arange(F) != j2)
    )
    ang3 = geometry.angle_deg(f1.normal[:, None, :], nt_r[None, :, :])  # (Fs,Ft)
    pair_ok = src_ok[:, None] & tar_ok[None, :] & (
        ang3 < params.third_normal_threshold
    )

    # 3-plane translation solve (:969-987): rows of A are raw source normals.
    c11 = f1.centroid[i1]
    c12 = f1.centroid[j1]
    c21 = f2.centroid[i2]
    c22 = f2.centroid[j2]
    d11 = jnp.dot(c11, n1)
    d12 = jnp.dot(c12, m1)
    d21 = jnp.dot(c21, n2)
    d22 = jnp.dot(c22, m2r)          # reference quirk (:973)
    d13 = jnp.sum(f1.centroid * f1.normal, axis=-1)      # (Fs,)
    d23 = jnp.sum(ct_r * nt_r, axis=-1)                   # (Ft,)
    D = jnp.stack(
        [
            jnp.broadcast_to((d11 - d21)[None, None], (F, F)),
            jnp.broadcast_to((d12 - d22)[None, None], (F, F)),
            d13[:, None] - d23[None, :],
        ],
        axis=-1,
    )  # (Fs, Ft, 3)
    A = jnp.stack(
        [
            jnp.broadcast_to(n1[None], (F, 3)),
            jnp.broadcast_to(m1[None], (F, 3)),
            f1.normal,
        ],
        axis=-2,
    )  # (Fs, 3, 3)
    AtA = A.mT @ A
    P = _inv3x3(AtA) @ A.mT  # (Fs, 3, 3)
    T3 = jnp.einsum("sij,stj->sti", P, D)  # (Fs, Ft, 3)

    # Fallback translation (:1000-1017).
    w11, w12 = f1.point_size[i1], f1.point_size[j1]
    w21, w22 = f2.point_size[i2], f2.point_size[j2]
    src_center = (c11 * w11 + c12 * w12) / jnp.maximum(w11 + w12, 1e-12)
    tar_center = (c21 * w21 + c22 * w22) / jnp.maximum(w21 + w22, 1e-12)
    t_fb = src_center - R @ tar_center

    quat = geometry.matrix_to_quat(R)
    fallback = ~jnp.any(pair_ok)
    return quat, T3, pair_ok, t_fb, fallback


def generate_hypotheses(
    f1: Faces,
    f2: Faces,
    b1: Bases,
    b2: Bases,
    params: FCCFParams,
    caps: Capacities,
) -> Hypotheses:
    B = b1.valid.shape[0]
    F = f1.valid.shape[0]
    M = caps.max_matches
    H = caps.max_hypotheses

    # (B1 x B2) compatibility (:1420), flattened b1-major (reference order).
    match = (
        b1.valid[:, None]
        & b2.valid[None, :]
        & (jnp.abs(b1.angle[:, None] - b2.angle[None, :]) < params.angle_same)
        & (b1.type_[:, None] == b2.type_[None, :])
    )
    bi1 = jnp.broadcast_to(b1.i[:, None], (B, B))
    bj1 = jnp.broadcast_to(b1.j[:, None], (B, B))
    bi2 = jnp.broadcast_to(b2.i[None, :], (B, B))
    bj2 = jnp.broadcast_to(b2.j[None, :], (B, B))
    btype = jnp.broadcast_to(b1.type_[:, None], (B, B))

    (m_count, m_overflow, m_valid, mi1, mj1, mi2, mj2, mtype) = compact(
        match, M, bi1, bj1, bi2, bj2, btype
    )

    quat, T3, pair_ok, t_fb, fb = jax.vmap(
        lambda a, b, c, d: _match_one(f1, f2, a, b, c, d, params)
    )(mi1, mj1, mi2, mj2)

    # Slot layout per match: F*F third-plane hits (s-major) then 1 fallback —
    # identical to the reference's emission order inside computer_transform.
    S = F * F + 1
    slot_valid = jnp.concatenate(
        [
            (pair_ok & m_valid[:, None, None]).reshape(M, F * F),
            (fb & m_valid)[:, None],
        ],
        axis=1,
    )  # (M, S)
    slot_t = jnp.concatenate([T3.reshape(M, F * F, 3), t_fb[:, None, :]], axis=1)

    # Two-stage compaction: a direct compaction over the M*S (~4M) slot
    # grid costs a 4M-update scatter. Instead extract
    # each match's first `PER_MATCH` hits with top_k (hits per match are
    # sparse: measured max 9 on room scenes, 21 on pillar halls — sized
    # per preset by caps.per_match_hits; extras raise the overflow flag),
    # then compact M*PER_MATCH slots. top_k on the negated slot index
    # returns positions in ascending slot order, preserving the
    # reference's enumeration order.
    PER_MATCH = min(caps.per_match_hits, S)
    neg = jnp.where(slot_valid, -jnp.arange(S, dtype=jnp.int32)[None, :], -S - 1)
    vals, idxs = jax.lax.top_k(neg, PER_MATCH)  # (M, PER_MATCH)
    hit_valid = vals > -S - 1
    row_overflow = jnp.any(
        jnp.sum(slot_valid, axis=1) > PER_MATCH
    )  # > PER_MATCH hits in one match: extras dropped (flagged)

    # Deferred payload extraction: the compaction carries ONLY each hit's
    # flat (match * S + slot) index; the (H,)-sized output then gathers
    # translation/quat/type straight from the per-match tables. Nothing
    # (M * PER_MATCH)-wide materializes beyond the validity bits and one
    # int32 index (no (M*K, 3) hit-translation gather).
    flat = jnp.arange(M, dtype=jnp.int32)[:, None] * S + idxs  # (M, K)
    (h_count, h_overflow, h_valid, hflat) = compact(hit_valid, H, flat)
    hm = hflat // S
    ht = jnp.where(h_valid[:, None], slot_t.reshape(M * S, 3)[hflat], 0.0)
    hq = jnp.where(h_valid[:, None], quat[hm], 0.0)
    htype = jnp.where(h_valid, mtype[hm], 0)
    return Hypotheses(
        quat=hq,
        t=ht,
        type_=htype,
        valid=h_valid,
        count=h_count,
        overflow=h_overflow | m_overflow | row_overflow,
    )

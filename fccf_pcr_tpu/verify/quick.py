"""Quick (coarse) verification: plane-overlap scoring + refinement trigger.

Rebuild of ``quick_verify`` (FCCF.cpp:680-783, C11): transform the target
faces, find coplanar source-target face pairs (angle < 10 deg and plane
offset difference < 2 m), keep the best candidate per source face by
min/max size ratio, refine the transform when >= 4 pairs matched
(composing T <- DeltaT @ T), and return the sum of pair importances
(2*min / (sum sizes)).

Tensor form: one (F1 x F2) predicate tensor + masked argmax per source face;
vmapped by the caller over all cluster representatives of all types.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import FCCFParams
from ..features.faces import Faces
from ..ops import geometry
from ..refine.gauss_newton import refine_pairs


def match_faces(T, f1: Faces, f2: Faces, params: FCCFParams):
    """Pair matching + scoring under transform T (:683-769). Returns
    (score, n_pairs, n2t_best, c2t_best, importance) where the last three
    describe the matched (transformed) target plane per source face.

    NOTE (exactness of the deferred-refinement split): in the reference,
    pair selection and the score both use the transform *before*
    refinement — ``ceres_refine`` runs after the matching loop and only
    updates the matrix (:771-782). So the score of a representative is
    independent of its refinement, and refinement can be deferred to the
    candidates that are actually consumed downstream (the per-type top
    ``fine_verify_number``) with bit-identical selection results.
    """
    R = T[:3, :3]
    t = T[:3, 3]
    c2t = f2.centroid @ R.T + t
    n2t = f2.normal @ R.T

    size1 = jnp.sum(jnp.where(f1.valid, f1.point_size, 0.0))
    size2 = jnp.sum(jnp.where(f2.valid, f2.point_size, 0.0))

    ang = geometry.angle_deg(f1.normal[:, None, :], n2t[None, :, :])
    d1 = jnp.sum(f1.normal * f1.centroid, axis=-1)
    d2 = jnp.sum(n2t * c2t, axis=-1)
    dist = jnp.abs(d1[:, None] - d2[None, :])
    cand = (
        f1.valid[:, None]
        & f2.valid[None, :]
        & (ang < params.qv_angle)
        & (dist < params.qv_dist)
    )

    ratio = jnp.minimum(f1.point_size[:, None], f2.point_size[None, :]) / jnp.maximum(
        jnp.maximum(f1.point_size[:, None], f2.point_size[None, :]), 1e-12
    )
    # First strictly-best candidate per source face (:742-755: strict >,
    # so ties keep the earliest index — argmax does the same).
    best_j = jnp.argmax(jnp.where(cand, ratio, -1.0), axis=1)
    pair_valid = jnp.any(cand, axis=1) & f1.valid

    min_sz = jnp.minimum(f1.point_size, f2.point_size[best_j])
    importance = jnp.where(
        pair_valid, 2.0 * min_sz / jnp.maximum(size1 + size2, 1e-12), 0.0
    )
    n_pairs = jnp.sum(pair_valid)
    score = jnp.sum(importance)
    return score, n_pairs, n2t[best_j], c2t[best_j], importance


def refine_transform(T, f1: Faces, f2: Faces, params: FCCFParams):
    """Re-match under T and apply the LM refinement (T <- dT @ T) when
    >= required_optimize pairs matched (:772-776)."""
    _, n_pairs, n2b, c2b, importance = match_faces(T, f1, f2, params)
    dT = refine_pairs(
        n1=f1.normal,
        p1=f1.centroid,
        n2=n2b,
        p2=c2b,
        w=importance,
        iters=params.refine_iters,
    )
    do_refine = n_pairs >= params.required_optimize
    return jnp.where(do_refine, dT @ T, T)


def quick_verify(T, f1: Faces, f2: Faces, params: FCCFParams):
    """Full quick_verify (:680-783): returns (T_refined, score, n_pairs).
    Kept as the reference-shaped primitive; the pipeline driver uses the
    split match_faces/refine_transform for the deferred-refinement
    optimization (see match_faces docstring)."""
    score, n_pairs, n2b, c2b, importance = match_faces(T, f1, f2, params)
    dT = refine_pairs(
        n1=f1.normal,
        p1=f1.centroid,
        n2=n2b,
        p2=c2b,
        w=importance,
        iters=params.refine_iters,
    )
    do_refine = n_pairs >= params.required_optimize
    T_out = jnp.where(do_refine, dT @ T, T)
    return T_out, score, n_pairs

"""Fused affinity + min-label-propagation sweep: a Pallas kernel for the GPU
(Triton route).

Replaces the plain path in features/faces.py (build the (V, V) boolean
affinity from four (V, 3) x (3, V) products, then sweep
``labels <- min(labels, affinity-neighbour labels)``) with a kernel that

  - computes the compare_normal / compare_plane predicates (FCCF.cpp:369-407)
    in registers from per-voxel stats, so neither the (V, V) products nor
    the affinity are ever written to device memory;
  - stops at the runtime occupancy ``bound``: slots at or past it are
    invalid by contract, so a sweep costs bound^2 predicate evaluations
    instead of V^2 (pass 2 of face growth runs on a compacted prefix of a
    few hundred representatives).

One ``pallas_call`` is one Jacobi sweep. Program ``p`` owns rows
[p*BI, (p+1)*BI): it reads the old labels, scans the j-chunks below the
bound in a loop, and writes its rows of the new labels. The convergence
test and the pointer-jumping rounds run in XLA between calls, inside the
same ``while_loop`` shape as the plain path, so both reach the same
fixpoint: the minimum slot index of each connected component.

Stats are field-major (fields, V) so that a program loads each field of a
j-chunk as one contiguous row.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import geometry

_BIG = 2**30  # python int: jnp scalars become captured consts in kernels

# Rows per program, j-chunk width and warps per program. In two sweeps of
# BI x BJ x warps on an H100 (PERF.md) this shape had the lowest heritage
# (V=9216) stage time, 6.93 ms at 700 W and 6.98-7.07 ms at 400 W; the
# other BI=8/16 shapes ran 7.1-10.9 ms, BI=32/64 8.2-61.5 ms (wide row
# blocks spill registers). At office width the BI=8/16 shapes were within
# run-to-run noise of each other.
BI = 16
BJ = 128
NUM_WARPS = 4
# Path-halving rounds between sweeps: 1, 2, 4 and 8 measured the same on
# the H100, so the cheapest.
JUMP_ROUNDS = 1

# Field rows of the packed stats (see _pack_stats).
_NHX, _NHY, _NHZ, _CX, _CY, _CZ, _RDC, _C2, _RNX, _RNY, _RNZ, _VALID = range(12)


def _sweep_kernel(stats_ref, params_ref, bound_ref, labels_ref, out_ref, *,
                  BI: int, BJ: int):
    i0 = pl.program_id(0) * BI
    rows = pl.ds(i0, BI)
    cos_gate = params_ref[0]
    l = params_ref[1]
    k = params_ref[2]
    bound = bound_ref[0]

    def col(f):  # (BI, 1) field of the row block
        return stats_ref[f, rows][:, None]

    nhx_i, nhy_i, nhz_i = col(_NHX), col(_NHY), col(_NHZ)
    cx_i, cy_i, cz_i = col(_CX), col(_CY), col(_CZ)
    rdc_i, c2_i = col(_RDC), col(_C2)
    rnx_i, rny_i, rnz_i = col(_RNX), col(_RNY), col(_RNZ)

    def j_chunk(jc, cand):
        cols = pl.ds(jc * BJ, BJ)

        def row(f):  # (1, BJ) field of the j-chunk
            return stats_ref[f, cols][None, :]

        cx_j, cy_j, cz_j = row(_CX), row(_CY), row(_CZ)
        rnx_j, rny_j, rnz_j = row(_RNX), row(_RNY), row(_RNZ)
        # The same expressions, in the same order, as
        # features.faces._pairwise_affinity.
        cosm = nhx_i * row(_NHX) + nhy_i * row(_NHY) + nhz_i * row(_NHZ)
        cicj = cx_i * cx_j + cy_i * cy_j + cz_i * cz_j
        dist = jnp.sqrt(jnp.maximum(c2_i + row(_C2) - 2.0 * cicj, 0.0))
        m1 = rdc_i - (rnx_i * cx_j + rny_i * cy_j + rnz_i * cz_j)
        m2 = (cx_i * rnx_j + cy_i * rny_j + cz_i * rnz_j) - row(_RDC)
        t = l / (k * dist + 1.0)
        plane_ok = (jnp.abs(m1) < t * dist) & (jnp.abs(m2) < t * dist)
        aff = (cosm >= cos_gate) & (plane_ok | (dist <= 1e-9))
        # Invalid slots carry label _BIG, so they need no validity term.
        lbl_j = labels_ref[cols][None, :]
        return jnp.minimum(
            cand, jnp.min(jnp.where(aff, lbl_j, _BIG), axis=1)
        )

    # Rows at or past the bound are invalid: their programs only copy.
    nb = jnp.where(i0 < bound, pl.cdiv(bound, BJ), 0)
    cand = jax.lax.fori_loop(0, nb, j_chunk, jnp.full((BI,), _BIG, jnp.int32))
    old = labels_ref[rows]
    valid_i = stats_ref[_VALID, rows] > 0.5
    out_ref[rows] = jnp.where(valid_i, jnp.minimum(old, cand), old)


def _pack_stats(normal, centroid, valid):
    """(12, V) field-major stats in the row order of the _NHX.. constants."""
    nh = geometry.normalize(normal)
    rdotc = jnp.sum(normal * centroid, axis=-1)
    c2 = jnp.sum(centroid * centroid, axis=-1)
    return jnp.stack(
        [
            nh[:, 0], nh[:, 1], nh[:, 2],
            centroid[:, 0], centroid[:, 1], centroid[:, 2],
            rdotc, c2,
            normal[:, 0], normal[:, 1], normal[:, 2],
            valid.astype(normal.dtype),
        ]
    )


def padded_size(V: int, block=(BI, BJ)) -> int:
    """V rounded up to a multiple of both block sizes."""
    m = max(block)
    return -(-V // m) * m


def label_propagate(
    normal, centroid, valid, angle_thresh_deg, l, k, *, bound=None,
    max_iters: int = 32, block=(BI, BJ), interpret: bool = False,
):
    """Connected-component min labels of the compare_normal/compare_plane
    affinity graph; the same labels as features.faces._label_propagate
    over features.faces._pairwise_affinity.

    ``bound`` (traced int32, optional): every valid slot index is < bound.
    V need not be a block multiple: the stats are padded with invalid
    slots up to ``padded_size(V, block)``."""
    V = normal.shape[0]
    bi, bj = block
    Vp = padded_size(V, block)
    pad = Vp - V
    stats = jnp.pad(_pack_stats(normal, centroid, valid), ((0, 0), (0, pad)))
    valid_p = jnp.pad(valid, (0, pad))
    cos_gate = jnp.cos(jnp.deg2rad(angle_thresh_deg)).astype(normal.dtype)
    params = jnp.stack(
        [cos_gate, jnp.asarray(l, normal.dtype), jnp.asarray(k, normal.dtype)]
    )
    bound = jnp.asarray(V if bound is None else bound, jnp.int32).reshape(1)

    sweep = pl.pallas_call(
        functools.partial(_sweep_kernel, BI=bi, BJ=bj),
        out_shape=jax.ShapeDtypeStruct((Vp,), jnp.int32),
        grid=(Vp // bi,),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="label_prop_sweep",
    )

    def jump(labels):
        # Path-halving (see features.faces.pointer_jump): O(V) gathers that
        # shortcut label chains, so few O(bound^2) sweeps are needed.
        labels = jax.lax.fori_loop(
            0, JUMP_ROUNDS,
            lambda _, x: jnp.minimum(x, x[jnp.minimum(x, Vp - 1)]),
            labels,
        )
        return jnp.where(valid_p, labels, _BIG)

    def body(state):
        labels, _, it = state
        new = jump(sweep(stats, params, bound, labels))
        return new, jnp.any(new != labels), it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    init = jnp.where(valid_p, jnp.arange(Vp, dtype=jnp.int32), _BIG)
    labels, _, _ = jax.lax.while_loop(
        cond, body, (init, jnp.bool_(True), jnp.int32(0))
    )
    return labels[:V]

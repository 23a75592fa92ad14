"""Graceful-degradation tests: force every fixed capacity to overflow and
assert (a) the matching STATUS_* bit fires and (b) the output stays finite.

The reference's std::vector stages are unbounded (FCCF.cpp:1414-1427
fan-out); the JAX rebuild replaces them with fixed-capacity masked tensors
whose contract (config.py Capacities docstring) is "overflow degrades
gracefully and raises a status flag". These tests make that contract
load-bearing rather than compile-time-only.

Each test shrinks ONE capacity far below what the standard small scene
needs, so the flag attribution is unambiguous. Small scenes keep the CPU
compile per distinct Capacities tolerable.
"""

import numpy as np
import pytest

from fccf_pcr_tpu import make_register_fn
from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.pipeline.register import (
    STATUS_FINE_ALIAS,
    STATUS_FINE_OVERFLOW,
    STATUS_HYPOTHESIS_OVERFLOW,
    STATUS_REP_OVERFLOW,
    STATUS_RESIDUAL_OVERFLOW,
    STATUS_VOXEL_OVERFLOW,
)


def _run(params, caps, seed=3, clutter=900):
    src, tar, _ = synthetic.make_pair(
        seed=seed, points_per_plane=1500, clutter_points=clutter
    )
    sp, sm = synthetic.pad_points(src, caps.max_points)
    tp, tm = synthetic.pad_points(tar, caps.max_points)
    res = make_register_fn(params, caps)(sp, sm, tp, tm)
    T = np.asarray(res.transform)
    assert np.isfinite(T).all(), T
    np.testing.assert_allclose(T[3], [0, 0, 0, 1], atol=1e-6)
    return int(res.status)


def test_voxel_overflow_flagged(params, caps):
    status = _run(params, caps.replace(max_voxels=32))
    assert status & STATUS_VOXEL_OVERFLOW


def test_hypothesis_overflow_flagged(params, caps):
    status = _run(params, caps.replace(max_hypotheses=16))
    assert status & STATUS_HYPOTHESIS_OVERFLOW


def test_match_overflow_flagged(params, caps):
    # the (base1, base2) match compaction feeds the same flag (C18 fan-out)
    status = _run(params, caps.replace(max_matches=8))
    assert status & STATUS_HYPOTHESIS_OVERFLOW


def test_rep_overflow_flagged(params, caps):
    # max_clusters bounds the compacted seed-cluster walk; the scene
    # produces hundreds of seed clusters in the dominant type.
    status = _run(params, caps.replace(max_clusters=4))
    assert status & STATUS_REP_OVERFLOW


def test_residual_overflow_flagged(params, caps):
    status = _run(params, caps.replace(max_residual=16))
    assert status & STATUS_RESIDUAL_OVERFLOW


def test_fine_overflow_flagged(params, caps):
    # clutter spreads residual points over far more than 8 distinct 0.5 m
    # cells, so the fine source table must truncate and flag.
    status = _run(params, caps.replace(max_fine_voxels=8))
    assert status & STATUS_FINE_OVERFLOW


def test_per_match_hits_overflow_flagged(params, caps):
    # with only 1 third-plane hit extracted per base match, room scenes
    # (measured up to 9 hits/match) must truncate and flag.
    status = _run(params, caps.replace(per_match_hits=1))
    assert status & STATUS_HYPOTHESIS_OVERFLOW


def test_fine_alias_flagged(params, caps):
    # A far-away clutter cluster in BOTH clouds stretches the SOURCE
    # residual's cell span past the 1024-cells-per-axis injective range of
    # the packed fine-verify key (>512 m at the 0.5 m default): the
    # source-table wrap must be FLAGGED, never silent (the reference
    # octree is extent-unbounded, FCCF.cpp:792-796). Target-side span
    # needs no flag — out-of-window target cells are dropped from the
    # join (tests/test_fine_verify.py covers that side). Voxel capacity
    # gets headroom so the far cluster actually reaches the residual
    # cloud instead of being dropped at the voxel stage.
    wide_caps = caps.replace(max_voxels=4096, max_residual=1 << 14,
                             wide_extent=True)
    src, tar, _ = synthetic.make_pair(
        seed=3, points_per_plane=1500, clutter_points=900
    )
    rng = np.random.default_rng(7)
    # a dense isotropic blob INSIDE one 2.5 m face voxel: enough points to
    # clear the min-points gate, curvature far above the planarity
    # threshold, so the whole blob lands in the residual cloud (thinly
    # spread points would fall in below-threshold voxels and be dropped
    # outright; planar patches would become faces — neither reaches the
    # fine stage)
    far = rng.uniform(600.1, 602.4, (400, 3)).astype(np.float32)
    src = np.concatenate([src, far])
    tar = np.concatenate([tar, far])
    sp, sm = synthetic.pad_points(src, wide_caps.max_points)
    tp, tm = synthetic.pad_points(tar, wide_caps.max_points)
    res = make_register_fn(params, wide_caps)(sp, sm, tp, tm)
    assert np.isfinite(np.asarray(res.transform)).all()
    assert int(res.status) & STATUS_FINE_ALIAS


def test_no_spurious_overflow(params, caps):
    # the standard caps fit the standard scene: no overflow bit may fire.
    status = _run(params, caps)
    assert status == 0

"""Output-level parity: JAX pipeline vs the faithful NumPy twin.

The twin (twin/twin.py) reproduces the reference's sequential greedy
semantics exactly; the JAX pipeline uses order-independent label
propagation. SURVEY.md §7 defines parity at the final-transform level
(RTE/RRE tolerance), not the face-set level — this test enforces it.
"""

import numpy as np
import pytest

from fccf_pcr_tpu import registration_errors
from fccf_pcr_tpu.twin import twin


@pytest.mark.slow
def test_transform_parity_small_scene(params, caps):
    import jax.numpy as jnp

    from fccf_pcr_tpu import make_register_fn
    from fccf_pcr_tpu.io import synthetic

    src, tar, T_gt = synthetic.make_pair(
        seed=21, points_per_plane=800, clutter_points=400, room=(10.0, 8.0, 3.0)
    )

    T_twin = twin.register_pair(src, tar, params)
    rre_t, rte_t = registration_errors(
        jnp.asarray(T_twin, jnp.float32), jnp.asarray(T_gt)
    )

    fn = make_register_fn(params, caps)
    sp, sm = synthetic.pad_points(src, caps.max_points)
    tp, tm = synthetic.pad_points(tar, caps.max_points)
    res = fn(sp, sm, tp, tm)
    rre_p, rte_p = registration_errors(res.transform, jnp.asarray(T_gt))

    # both recover ground truth
    assert float(rre_t) < 1.0 and float(rte_t) < 0.2, (
        f"twin off GT: {float(rre_t)} deg {float(rte_t)} m"
    )
    assert float(rre_p) < 1.0 and float(rte_p) < 0.2, (
        f"pipeline off GT: {float(rre_p)} deg {float(rte_p)} m"
    )

    # and agree with each other at transform level. Band sized to the
    # MEASURED envelope (production-density 24-pair diff worst case is
    # 0.52 deg / 0.125 m, docs/ROADMAP.md; this miniature pair agrees far
    # tighter) — the old 1.5/0.3 band was 3x the measured envelope, wide
    # enough for a face-membership regression to hide inside
    # (VERDICT r4 item 6).
    rre_x, rte_x = registration_errors(
        res.transform, jnp.asarray(T_twin, jnp.float32)
    )
    assert float(rre_x) < 0.75 and float(rte_x) < 0.15, (
        f"pipeline vs twin: {float(rre_x)} deg {float(rte_x)} m"
    )

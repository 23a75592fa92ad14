"""Twin parity at PRODUCTION density (VERDICT r3 item 5).

tests/golden/twin_production.json caches the NumPy twin's final
transforms on the BENCH scene pairs (12k+ points/plane — the density
where face merges actually contend; generated by
tools/twin_production.py --generate, ~30 s+/pair offline). This test
runs the JAX pipeline on a subset of those pairs and enforces
transform-level agreement with the reference's sequential greedy
semantics (FCCF.cpp:536-648, :1040-1231) — the order-dependence risk of
SURVEY.md §7 hard part #1, previously only covered by 800-point
miniatures (test_twin_parity.py).

Subset: the first 2 seeds of each config (full coverage is
``python tools/twin_production.py --check``); building-scale configs are
exercised too — they are exactly where voxel counts peak.
"""

import json
import pathlib

import numpy as np
import pytest

FIXTURE = pathlib.Path(__file__).parent / "golden" / "twin_production.json"

# pipeline-vs-twin disagreement bands sized ~1.5x the MEASURED envelope
# (full 24-pair `tools/twin_production.py --check`, CPU backend,
# 2026-08-20): office worst 0.077 deg/0.014 m; structured 0.914/0.094
# (the divergent stairs seeds are ones where the TWIN sits 0.6-0.9 deg
# off GT while the pipeline is at ~0.07 — sequential greedy growth keeps
# junction-contaminated memberships the label-prop pipeline splits);
# resso 0.0/0.009; heritage 0.026/0.213 (seed 0's translation basin,
# pinned at the same value in tests/golden/pipeline.json). The old bands
# were ~3x this envelope — wide enough for a face-membership regression
# to hide inside (VERDICT r4 item 6).
BANDS = {
    "office": (0.15, 0.03),
    "structured": (1.3, 0.15),
    "resso": (0.5, 0.08),
    "heritage": (0.5, 0.3),
}

pytestmark = pytest.mark.skipif(
    not FIXTURE.exists(),
    reason="twin production fixture not generated "
    "(run tools/twin_production.py --generate)",
)


def _rows():
    if not FIXTURE.exists():
        return []
    rows = json.loads(FIXTURE.read_text())["rows"]
    picked = []
    seen = {}
    for r in rows:
        if seen.setdefault(r["config"], 0) < 2:
            seen[r["config"]] += 1
            picked.append(r)
    return picked


@pytest.mark.slow
@pytest.mark.parametrize(
    "row", _rows(), ids=lambda r: f"{r['config']}-s{r['seed']}"
)
def test_pipeline_matches_twin_at_production_density(row):
    import jax

    import bench
    from fccf_pcr_tpu import make_register_fn
    from fccf_pcr_tpu.io import synthetic
    from fccf_pcr_tpu.models.fccf import get_model
    from fccf_pcr_tpu.pipeline.register import pre_downsample

    cfg = bench.CONFIGS[row["config"]]
    model = get_model(cfg["model"])
    ((src, tar, T_gt),) = bench.pairs_for_config(cfg, [row["seed"]])
    # the fixture pins the scene geometry: a drifted synthetic generator
    # would silently invalidate the comparison
    assert (len(src), len(tar)) == (row["n_src"], row["n_tar"]), (
        "synthetic scene generator changed since the fixture was made — "
        "regenerate tools/twin_production.py --generate"
    )

    pre = jax.jit(lambda p, m: pre_downsample(p, m, model.params, model.caps))
    sp, sm = synthetic.pad_points(src, model.caps.raw_points)
    tp, tm = synthetic.pad_points(tar, model.caps.raw_points)
    spd, smd, _ = pre(sp, sm)
    tpd, tmd, _ = pre(tp, tm)
    res = make_register_fn(model.params, model.caps)(spd, smd, tpd, tmd)

    T_pipe = np.asarray(res.transform, np.float64)
    T_twin = np.asarray(row["T_twin"], np.float64).reshape(4, 4)
    R = T_pipe[:3, :3] @ T_twin[:3, :3].T
    rre = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))
    rte = np.linalg.norm(T_pipe[:3, 3] - T_twin[:3, 3])
    band = BANDS[row["config"]]
    assert rre < band[0] and rte < band[1], (
        f"pipeline diverges from reference-semantics twin at production "
        f"density: {rre:.4f} deg / {rte:.5f} m (band {band}; "
        f"twin-vs-GT was {row['rre_gt_deg']} deg / {row['rte_gt_m']} m)"
    )

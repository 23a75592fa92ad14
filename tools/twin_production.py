"""Twin parity at PRODUCTION scale (VERDICT r3 item 5).

The NumPy twin (twin/twin.py) reproduces the reference's sequential
greedy semantics (FCCF.cpp:536-648 growth, :1040-1231 clustering); the
JAX pipeline replaces them with order-independent reformulations. The
standing risk (SURVEY.md §7 hard part #1) is a divergence that only
appears at densities where face merges actually contend — the in-suite
parity test runs 800-point miniatures, the bench runs 12k points/plane.

This tool closes that gap: it runs the twin on the BENCH scene pairs
(bench.pairs_for_config — the exact seed-to-scene assignment the driver
measures) and caches the twin's final transforms as a committed fixture,
so a slow test can compare the pipeline against the reference semantics
at production density without paying twin runtime (~30 s/office pair,
more at building scale) on every run.

Usage:
    # regenerate the fixture (CPU-only, no accelerator needed; ~15-40 min):
    python tools/twin_production.py --generate
    # compare the pipeline (current backend) against the cached twin:
    python tools/twin_production.py --check

The committed fixture is tests/golden/twin_production.json; the slow
test tests/test_twin_production.py consumes it (CPU mesh suite).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURE = os.path.join(ROOT, "tests", "golden", "twin_production.json")

# (config, seeds): office + structured per the verdict, plus BOTH
# building-scale families (twin runtime there is the price of covering
# the scenes where voxel counts — and thus merge contention — peak).
PLAN = [
    ("office", list(range(8))),
    ("structured", list(range(8))),  # round-robins stairs/hall by seed
    ("resso", list(range(4))),
    ("heritage", list(range(4))),
]


def _errors(T, T_ref):
    R = T[:3, :3] @ T_ref[:3, :3].T
    rre = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))
    rte = np.linalg.norm(T[:3, 3] - T_ref[:3, 3])
    return float(rre), float(rte)


def generate():
    """Resumable: each finished pair appends to FIXTURE+'.partial'
    (JSONL) immediately; already-present (config, seed) rows are skipped
    on restart; the final JSON fixture is assembled from the partial."""
    import bench
    from fccf_pcr_tpu.models.fccf import get_model
    from fccf_pcr_tpu.twin import twin

    partial = FIXTURE + ".partial"
    done = {}
    if os.path.exists(partial):
        with open(partial) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done[(r["config"], r["seed"])] = r
    with open(partial, "a") as out:
        for cfg_name, seeds in PLAN:
            todo = [s for s in seeds if (cfg_name, s) not in done]
            if not todo:
                continue
            cfg = bench.CONFIGS[cfg_name]
            params = get_model(cfg["model"]).params
            pairs = bench.pairs_for_config(cfg, todo)
            for s, (src, tar, T_gt) in zip(todo, pairs):
                t0 = time.time()
                T = twin.register_pair(src, tar, params)
                dt = time.time() - t0
                rre, rte = _errors(T, T_gt)
                row = {
                    "config": cfg_name,
                    "seed": s,
                    "n_src": int(len(src)),
                    "n_tar": int(len(tar)),
                    "T_twin": np.asarray(T, np.float64).round(9).ravel().tolist(),
                    "T_gt": np.asarray(T_gt, np.float64).round(9).ravel().tolist(),
                    "rre_gt_deg": round(rre, 5),
                    "rte_gt_m": round(rte, 6),
                    "twin_s": round(dt, 1),
                }
                done[(cfg_name, s)] = row
                out.write(json.dumps(row) + "\n")
                out.flush()
                print(f"{cfg_name}/{s}: {dt:.0f}s rre={rre:.4f} "
                      f"rte={rte:.5f}", flush=True)
    rows = [done[(c, s)] for c, ss in PLAN for s in ss if (c, s) in done]
    with open(FIXTURE, "w") as f:
        json.dump({"rows": rows}, f, indent=1)
    print(f"wrote {len(rows)} rows -> {FIXTURE}")


def check(configs=None, batch_override=None):
    """Run the pipeline on the fixture pairs (current JAX backend) and
    report transform-level twin agreement. Returns the worst (rre, rte)
    pipeline-vs-twin disagreement over pairs where the twin itself
    recovered ground truth."""
    import bench
    import jax
    from fccf_pcr_tpu import make_register_fn
    from fccf_pcr_tpu.io import synthetic
    from fccf_pcr_tpu.models.fccf import get_model

    with open(FIXTURE) as f:
        rows = json.load(f)["rows"]
    by_cfg = {}
    for r in rows:
        by_cfg.setdefault(r["config"], []).append(r)

    worst = (0.0, 0.0)
    for cfg_name, rs in by_cfg.items():
        if configs and cfg_name not in configs:
            continue
        cfg = bench.CONFIGS[cfg_name]
        model = get_model(cfg["model"])
        fn = make_register_fn(model.params, model.caps)
        pairs = bench.pairs_for_config(cfg, [r["seed"] for r in rs])
        for r, (src, tar, T_gt) in zip(rs, pairs):
            sp, sm = synthetic.pad_points(src, model.caps.raw_points)
            tp, tm = synthetic.pad_points(tar, model.caps.raw_points)
            from fccf_pcr_tpu.pipeline.register import pre_downsample

            spd, smd, _ = jax.jit(
                lambda p, m: pre_downsample(p, m, model.params, model.caps)
            )(sp, sm)
            tpd, tmd, _ = jax.jit(
                lambda p, m: pre_downsample(p, m, model.params, model.caps)
            )(tp, tm)
            res = fn(spd, smd, tpd, tmd)
            T_pipe = np.asarray(res.transform, np.float64)
            T_twin = np.asarray(r["T_twin"], np.float64).reshape(4, 4)
            rre_x, rte_x = _errors(T_pipe, T_twin)
            rre_p, rte_p = _errors(
                T_pipe, np.asarray(r["T_gt"], np.float64).reshape(4, 4)
            )
            print(
                json.dumps(
                    {
                        "config": cfg_name,
                        "seed": r["seed"],
                        "pipe_vs_twin": [round(rre_x, 4), round(rte_x, 5)],
                        "pipe_vs_gt": [round(rre_p, 4), round(rte_p, 5)],
                        "twin_vs_gt": [r["rre_gt_deg"], r["rte_gt_m"]],
                        "status": int(res.status),
                    }
                ),
                flush=True,
            )
            worst = (max(worst[0], rre_x), max(worst[1], rte_x))
    print(f"worst pipeline-vs-twin: {worst[0]:.4f} deg  {worst[1]:.5f} m")
    return worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--generate", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--configs", default=None,
                    help="comma filter for --check")
    args = ap.parse_args()
    if args.generate:
        generate()
    if args.check:
        check(configs=args.configs.split(",") if args.configs else None)
    if not (args.generate or args.check):
        ap.error("pass --generate and/or --check")


if __name__ == "__main__":
    main()

"""Pre-warm the persistent XLA compile cache for the test suite
(VERDICT r3 item 8: a cold container pays ~7.5 min of serial CPU compile
time on the fast suite alone).

Compiles the suite's heavy graphs in PARALLEL subprocesses (XLA:CPU
compilation is mostly single-threaded per program, so concurrent
processes cut cold wall-clock by ~the parallelism factor). Each compile
lands in the persistent cache that tests/conftest.py also uses
(fccf_pcr_tpu/utils/cache.py), so the suite then starts warm.

Usage:
    python tools/warm_cache.py            # fast-suite graphs (TEST_CAPS)
    python tools/warm_cache.py --full     # + production preset graphs
                                          #   (golden/slow tests)
    python tools/warm_cache.py -j 8       # parallelism (default: cpu/2)

Safe to re-run: warm entries make every job a near-no-op.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax
from fccf_pcr_tpu.utils.cache import setup_compile_cache
setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
import numpy as np
from fccf_pcr_tpu.config import TEST_CAPS, FCCFParams
from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.pipeline.register import make_register_fn, pre_downsample

def _run_test_caps(caps, batched, mesh=False):
    params = FCCFParams(leaf_size=0.25)
    src, tar, _ = synthetic.make_pair(
        seed=3, points_per_plane=220, clutter_points=120,
        room=(7.0, 5.0, 3.0))
    sp, sm = synthetic.pad_points(src, caps.max_points)
    tp, tm = synthetic.pad_points(tar, caps.max_points)
    if batched:
        sp, sm, tp, tm = (np.stack([x] * 8) for x in (sp, sm, tp, tm))
    if mesh:
        from fccf_pcr_tpu.parallel.mesh import (
            make_mesh, make_sharded_register_fn)
        fn = make_sharded_register_fn(params, caps, make_mesh())
    else:
        fn = make_register_fn(params, caps, batched=batched)
    jax.block_until_ready(fn(sp, sm, tp, tm))

def _run_config(name):
    import sys
    sys.path.insert(0, {root!r})
    import bench
    from fccf_pcr_tpu.models.fccf import get_model
    cfg = bench.CONFIGS[name]
    model = get_model(cfg["model"])
    params, caps = model.params, model.caps
    fn = make_register_fn(params, caps, batched=True)
    pre = jax.jit(jax.vmap(lambda p, m: pre_downsample(p, m, params, caps)))
    pairs = bench.pairs_for_config(cfg, [0] * 8)
    sp = np.stack([synthetic.pad_points(p[0], caps.raw_points)[0] for p in pairs])
    sm = np.stack([synthetic.pad_points(p[0], caps.raw_points)[1] for p in pairs])
    tp = np.stack([synthetic.pad_points(p[1], caps.raw_points)[0] for p in pairs])
    tm = np.stack([synthetic.pad_points(p[1], caps.raw_points)[1] for p in pairs])
    spd, smd, _ = pre(sp, sm)
    tpd, tmd, _ = pre(tp, tm)
    jax.block_until_ready(fn(spd, smd, tpd, tmd))
"""

# label -> python statement run after the prelude
FAST_JOBS = {
    "test-caps-single": "_run_test_caps(TEST_CAPS, batched=False)",
    "test-caps-batched": "_run_test_caps(TEST_CAPS, batched=True)",
    "test-caps-mesh": "_run_test_caps(TEST_CAPS, batched=True, mesh=True)",
    "test-caps-wide": (
        "_run_test_caps(TEST_CAPS.replace(wide_extent=True), batched=True)"
    ),
    "golden-office": "_run_config('office')",
    "golden-structured": "_run_config('structured')",
}
FULL_JOBS = {
    "golden-apartment": "_run_config('apartment')",
    "golden-cross-season": "_run_config('cross-season')",
    "golden-resso": "_run_config('resso')",
    "golden-heritage": "_run_config('heritage')",
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also warm the production preset graphs used by "
                    "the slow/golden tests")
    ap.add_argument("-j", type=int, default=max(2, (os.cpu_count() or 4) // 2))
    args = ap.parse_args()

    jobs = dict(FAST_JOBS)
    if args.full:
        jobs.update(FULL_JOBS)

    prelude = _PRELUDE.format(root=ROOT)
    env = {**os.environ}
    t0 = time.time()
    pending = list(jobs.items())
    running = {}
    failures = []
    while pending or running:
        while pending and len(running) < args.j:
            label, stmt = pending.pop(0)
            p = subprocess.Popen(
                [sys.executable, "-c", prelude + "\n" + stmt],
                cwd=ROOT, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            )
            running[label] = (p, time.time())
            print(f"start {label}", flush=True)
        time.sleep(0.5)
        for label in list(running):
            p, ts = running[label]
            if p.poll() is None:
                continue
            del running[label]
            dt = time.time() - ts
            if p.returncode == 0:
                print(f"done  {label} ({dt:.0f}s)", flush=True)
            else:
                err = p.stderr.read().decode(errors="replace")[-400:]
                failures.append(label)
                print(f"FAIL  {label} ({dt:.0f}s): {err}", flush=True)
    print(f"warmed {len(jobs) - len(failures)}/{len(jobs)} graphs in "
          f"{time.time() - t0:.0f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

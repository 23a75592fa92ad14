"""Capture an on-chip profiler trace of one bench config's steady step.

Mirrors bench.py's setup exactly (same preset, same synthetic pairs, same
pre-downsample boundary — the reference's clock starts after main's
VoxelGrid pass, FCCF.cpp:1668-1685), warms the compile, then traces N
steady-state steps into a ``jax.profiler`` trace directory (an
``.xplane.pb`` under ``<out>/plugins/profile/``). The reduction of that
trace to per-stage device time is ROADMAP S2.

Usage:
    python tools/trace_config.py heritage --out TRACE_DIR [--steps 3]

One process per capture.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="bench config name (e.g. heritage)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", required=True, help="trace directory")
    ap.add_argument("--caps-set", action="append", default=[])
    ap.add_argument("--params-set", action="append", default=[])
    args = ap.parse_args()

    import bench
    import jax
    from fccf_pcr_tpu import make_register_fn
    from fccf_pcr_tpu.models.fccf import get_model
    from fccf_pcr_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    cfg = bench.CONFIGS[args.config]
    B = cfg.get("batch", 8)
    model = get_model(cfg["model"])
    params, caps = model.params, model.caps
    for ov in args.caps_set:
        key, _, val = ov.partition("=")
        caps = caps.replace(
            **{key: bench._coerce_like(getattr(caps, key), key, val, "--caps-set")}
        )
    for ov in args.params_set:
        key, _, val = ov.partition("=")
        params = params.replace(
            **{key: bench._coerce_like(
                getattr(params, key), key, val, "--params-set")}
        )

    batches, _ = bench.make_batches(args.config, cfg, params, caps, B)
    batch = batches[0]
    fn = make_register_fn(params, caps, batched=True)
    t0 = time.time()
    jax.block_until_ready(fn(*batch))
    print(f"# compile+first step: {time.time() - t0:.1f}s", file=sys.stderr)

    jax.profiler.start_trace(args.out)
    for _ in range(args.steps):
        res = fn(*batch)
    jax.block_until_ready(res)
    jax.profiler.stop_trace()
    print(f"# trace captured -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()

"""Command-line interface.

Contract-compatible with the reference CLI (FCCF.cpp:1646-1690, C20 /
README.md:15-18):

    python -m fccf_pcr_tpu SRC.ply TAR.ply VOXEL_SIZE

prints "Leaf size : <v>" and the 4x4 transformation matrix mapping SRC
into TAR's frame (the reference's argument swap at FCCF.cpp:1683 is folded
into the pipeline's direction convention — see pipeline/register.py).

Extras beyond the reference (structured observability, SURVEY.md §5):
    --json          emit a machine-readable record (T, scores, counts,
                    status flags, stage timings)
    --batch A B C…  register consecutive pairs of a scan list, vmapped
    --caps tiny|default|large|eth-*|resso|heritage   capacity preset
    --device gpu|cpu            backend (default gpu; asking for the GPU on a
                                host without one is an error)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _caps_preset(name):
    from .config import Capacities, TEST_CAPS

    if name == "tiny":
        return TEST_CAPS
    from .models.fccf import REGISTRY

    if name in REGISTRY:  # measured model presets (eth-*, resso, heritage)
        return REGISTRY[name].caps
    if name == "large":
        return Capacities(
            max_points=1 << 19,
            max_voxels=8192,
            max_matches=4096,
            max_hypotheses=16384,
            max_residual=1 << 17,
            max_fine_voxels=1 << 16,
        )
    return Capacities()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="fccf",
        description="FCCF-PCR point cloud registration in JAX",
    )
    ap.add_argument("source", nargs="?", help="source PLY file")
    ap.add_argument("target", nargs="?", help="target PLY file")
    ap.add_argument("voxel", nargs="?", type=float, default=0.1,
                    help="voxel-grid leaf size in meters (default 0.1)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    # "default"/"large" are generic envelopes; the registry names select
    # the content-measured presets (models/fccf.py) a reference user would
    # pick per dataset.
    from .models.fccf import REGISTRY as _REG
    ap.add_argument("--caps", default="default",
                    choices=["tiny", "default", "large", "auto",
                             *(k for k in _REG if k != "tiny")],
                    help="capacity preset; 'auto' sizes the bounds from "
                         "the loaded scans themselves (models/auto.py) "
                         "and pairs with an escalation envelope, so new "
                         "datasets need no manual capacity tuning")
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"],
                    help="backend to run on (default gpu); a GPU run on a "
                         "host without one fails instead of falling back")
    ap.add_argument("--batch", nargs="+", default=None, metavar="PLY",
                    help="register consecutive pairs of this scan list")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides",
                    help="override any FCCFParams field (e.g. --set "
                         "curvature_threshold=0.08 --set fine_verify_number=6); "
                         "the reference hard-codes these (FCCF.cpp:120-176)")
    ap.add_argument("--out", default=None, metavar="JSONL",
                    help="with --batch: stream per-pair records to this file "
                         "(checkpoint/resume on restart)")
    ap.add_argument("--escalate-caps", default=None, metavar="PRESET",
                    choices=["default", "large", *(k for k in _REG if k != "tiny")],
                    help="re-run any pair whose status shows a capacity hit "
                         "under this larger preset (content-adaptive "
                         "dual-capacity execution; lets --caps stay tight "
                         "for the common case; --caps auto derives its own "
                         "escalation envelope when this is not given)")
    ap.add_argument("--native-io", action="store_true",
                    help="load the scan list with the threaded C++ batch "
                         "loader (csrc/, falls back to python)")
    args = ap.parse_args(argv)

    if args.device == "cpu":
        # Before the first jax import, so no other backend initializes.
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        ap.error(
            "--device gpu requested but JAX found no GPU "
            f"(jax.devices()={jax.devices()}); pass --device cpu to run "
            "on the CPU"
        )

    from .utils.cache import setup_compile_cache

    setup_compile_cache()

    import jax.numpy as jnp

    from . import FCCFParams, make_register_fn, __version__
    from .io.synthetic import pad_points
    from .pipeline.register import pre_downsample

    params = FCCFParams(leaf_size=args.voxel)
    for ov in args.overrides:
        key, _, val = ov.partition("=")
        if not hasattr(params, key):
            ap.error(f"unknown parameter '{key}'")
        field_type = type(getattr(params, key))
        # bool("0") is True and int("0.5") raises; route numerics through
        # float, everything else through the field's own constructor.
        if field_type is bool:
            coerced = val.lower() in ("1", "true", "yes", "on")
        elif field_type in (int, float):
            coerced = field_type(float(val))
        else:
            coerced = field_type(val)
        params = params.replace(**{key: coerced})
    # "auto" sizes capacities from the loaded clouds themselves; resolved
    # after loading (below). _resolve_caps also derives auto's escalation
    # envelope when --escalate-caps was not given.
    caps = None if args.caps == "auto" else _caps_preset(args.caps)
    escalate_caps = (
        _caps_preset(args.escalate_caps) if args.escalate_caps else None
    )

    def _resolve_caps(caps, escalate_caps, clouds):
        if caps is None:
            from .models.auto import auto_caps, auto_escalation_caps

            caps = auto_caps(clouds, params)
            if escalate_caps is None:
                escalate_caps = auto_escalation_caps(caps)
            print(
                f"# auto caps: points={caps.max_points} "
                f"raw={caps.raw_points} voxels={caps.max_voxels} "
                f"residual={caps.max_residual} fine={caps.max_fine_voxels} "
                f"wide_extent={caps.wide_extent}", file=sys.stderr,
            )
        return caps, escalate_caps

    if not args.json:
        print(f"Leaf size : {args.voxel:g}")

    scans = args.batch if args.batch else [args.source, args.target]
    if len(scans) < 2 or any(s is None for s in scans):
        ap.error("need a source and a target scan (or --batch LIST)")

    if args.batch and args.out:
        # dataset sweep path: consecutive pairs, streamed JSONL records
        from .io.pcd import read_cloud
        from .pipeline.sweep import run_sweep

        clouds = [read_cloud(p) for p in scans]
        caps, escalate_caps = _resolve_caps(caps, escalate_caps, clouds)
        pairs = [(clouds[i], clouds[i + 1]) for i in range(len(clouds) - 1)]
        records, summary = run_sweep(
            pairs, params, caps, batch_size=min(8, len(pairs)),
            out_path=args.out,
            escalate_caps=escalate_caps,
        )
        print(json.dumps({"summary": summary, "out": args.out}))
        return 0

    t_load0 = time.perf_counter()
    load_truncated: list[int] = []
    if args.native_io:
        from .io.native import native_read_ply_batch

        # Load at the LARGEST capacity any stage may use (escalation needs
        # the full cloud, and auto caps are unknown before loading).
        if caps is None:
            raw_cap = 1 << 20
        else:
            raw_cap = caps.raw_points
            if escalate_caps is not None:
                raw_cap = max(raw_cap, escalate_caps.raw_points)
        loaded = native_read_ply_batch(scans, raw_cap)
    else:
        loaded = None
    if loaded is not None:
        pts_arr, mask_arr, counts = loaded
        clouds = [pts_arr[i][mask_arr[i]] for i in range(len(scans))]
        # the batch loader subsamples at raw_cap and reports the true
        # size only via counts — truncation must be surfaced, not silent
        for i, cnt in enumerate(np.asarray(counts)):
            if cnt > raw_cap:
                print(f"# WARNING: scan {scans[i]} has {int(cnt)} points; "
                      f"subsampled at load to {raw_cap} (--caps large, or "
                      "load without --native-io)", file=sys.stderr)
                load_truncated.append(i)
    else:
        from .io.pcd import read_cloud

        clouds = [read_cloud(p) for p in scans]
    t_load = time.perf_counter() - t_load0
    caps, escalate_caps = _resolve_caps(caps, escalate_caps, clouds)

    # First (CLI-level) downsample, mirroring main() (:1668-1678); the
    # pipeline performs the second, internal downsample itself. Raw clouds
    # load at caps.raw_points and compact to the hot pipeline's max_points;
    # truncation at either capacity is surfaced, never silent.
    def run_at(stage_caps):
        pre = jax.jit(lambda p, m: pre_downsample(p, m, params, stage_caps))
        padded = []
        pre_overflow = list(load_truncated)  # native-load subsampling
        for k, c in enumerate(clouds):
            if len(c) > stage_caps.raw_points:
                print(f"# WARNING: scan {scans[k]} has {len(c)} points; "
                      f"subsampled to raw capacity {stage_caps.raw_points} "
                      "(use --caps large)", file=sys.stderr)
                pre_overflow.append(k)
            p, m = pad_points(c, stage_caps.raw_points)
            pd, md, ovf = pre(jnp.asarray(p), jnp.asarray(m))
            if bool(ovf) and k not in pre_overflow:
                print(f"# WARNING: scan {scans[k]} overflows max_points="
                      f"{stage_caps.max_points} after downsampling; "
                      "truncated (use --caps large)", file=sys.stderr)
                pre_overflow.append(k)
            padded.append((pd, md))

        fn = make_register_fn(
            params, stage_caps, batched=args.batch is not None
        )

        t0 = time.perf_counter()
        if args.batch:
            sp = jnp.stack([padded[i][0] for i in range(len(padded) - 1)])
            sm = jnp.stack([padded[i][1] for i in range(len(padded) - 1)])
            tp = jnp.stack([padded[i + 1][0] for i in range(len(padded) - 1)])
            tm = jnp.stack([padded[i + 1][1] for i in range(len(padded) - 1)])
            res = fn(sp, sm, tp, tm)
        else:
            res = fn(padded[0][0], padded[0][1], padded[1][0], padded[1][1])
        jax.block_until_ready(res)
        return res, sorted(set(pre_overflow)), time.perf_counter() - t0

    res, pre_overflow, t_reg = run_at(caps)

    escalated = False
    if escalate_caps is not None:
        from .pipeline.sweep import ESCALATION_STATUS_MASK

        if pre_overflow or bool(
            np.any(np.asarray(res.status) & ESCALATION_STATUS_MASK)
        ):
            print("# capacity hit at the tight caps; re-running at the "
                  "escalation preset", file=sys.stderr)
            res, pre_overflow, t_esc = run_at(escalate_caps)
            t_reg += t_esc
            escalated = True

    T = np.asarray(res.transform)
    if args.json:
        rec = {
            "version": __version__,
            "scans": scans,
            "leaf_size": args.voxel,
            "transform": T.tolist(),
            "quick_score": np.asarray(res.quick_score).tolist(),
            "fine_score": np.asarray(res.fine_score).tolist(),
            "n_faces": np.asarray(res.n_faces).tolist(),
            "n_hypotheses": np.asarray(res.n_hypotheses).tolist(),
            "status": np.asarray(res.status).tolist(),
            "preprocess_overflow": pre_overflow,
            "escalated": escalated,
            "time_load_s": t_load,
            "time_register_s": t_reg,
        }
        print(json.dumps(rec))
    else:
        print("Transformation: ")
        if T.ndim == 2:
            T = T[None]
        for k, Tk in enumerate(T):
            if len(T) > 1:
                print(f"# pair {k}: {scans[k]} -> {scans[k + 1]}")
            for row in Tk:
                print(" ".join(f"{v: .6f}" for v in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

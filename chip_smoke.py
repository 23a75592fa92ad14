"""Smoke run of the registration pipeline on a GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: the sharded path only

One process holds the card for the whole run. With one card the phases are:

  1. device check: JAX must find a GPU, and exactly as many as --chips,
     else exit 1 before compiling anything; prints the card's name and power limit (nvidia-smi), the
     JAX version and the compile-cache directory;
  2. office: 8 bench pairs of the eth-office preset through
     make_register_fn(batched=True); the bench.GATES limits and status 0
     for every pair; prints compile seconds, steady step ms, peak device
     memory and the step's memory_analysis();
  3. heritage: the same at the heritage preset (V=9216, ~238k points per
     downsampled cloud), the largest footprint in the repository;
  4. kernel: the label-propagation kernel (ops/pallas/label_prop.py)
     against the plain affinity-matrix path on the voxel stats of the
     office (V=1536) and heritage (V=9216) bench scenes, 8 clouds each;
     labels must be equal, and both times are printed. It runs after the
     pipeline phases because the plain path's (8, V, V) products would
     otherwise set the process's peak memory;
  5. CLI: one office pair written as PLY files and registered through
     fccf_pcr_tpu.cli.main(... --device gpu --json) in this process; the
     transform must be finite and inside the office gate.

With ``--chips 4`` the office batch runs through make_sharded_register_fn
over a 4-GPU mesh and through make_register_fn on device 0; the sharded
output must span 4 devices, the statuses must be equal and both runs must
be inside the office gate.

Any failed phase makes the exit code 1. Only a run in which every phase
passed prints, as its last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

STEADY_ITERS = 5


class PhaseError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def _steady_ms(fn, *args):
    """Median and min wall ms of ``fn(*args)`` after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(STEADY_ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), float(np.min(times))


def _preset(name):
    import bench
    from fccf_pcr_tpu.models.fccf import get_model

    cfg = bench.CONFIGS[name]
    model = get_model(cfg["model"])
    return cfg, model.params, model.caps


def pass1_inputs(name, batch=8):
    """Pass-1 face-growth inputs of ``batch`` target clouds of a bench
    scene: (normal, centroid, planar valid, occupancy bound), each with a
    leading cloud axis, and the params."""
    import bench
    import jax
    import jax.numpy as jnp

    from fccf_pcr_tpu.features.faces import voxel_planes
    from fccf_pcr_tpu.ops.voxelize import downsample_and_voxelize

    cfg, params, caps = _preset(name)
    batches, _ = bench.make_batches(name, cfg, params, caps, batch)
    _, _, tp, tm = batches[0]

    def stats(pts, msk):
        d, _, vs, pv, _ = downsample_and_voxelize(
            pts, msk, params.leaf_size, params.face_voxel_size,
            caps.max_voxels, wide_extent=caps.wide_extent,
        )
        normal, enough, planar = voxel_planes(vs, d, pv, params)
        vvalid = vs.valid & enough & planar
        V = caps.max_voxels
        bound = jnp.max(jnp.where(vvalid, jnp.arange(V), -1)) + 1
        return normal, vs.centroid, vvalid, bound.astype(jnp.int32)

    return jax.jit(jax.vmap(stats))(tp, tm), params


def label_prop_fns(params):
    """(kernel, plain): jitted, vmapped pass-1 label propagation by the
    Pallas kernel and by the plain affinity-matrix path."""
    import jax

    from fccf_pcr_tpu.features import faces
    from fccf_pcr_tpu.ops.pallas import label_prop

    gate = (params.normal_thresh1, params.l1, params.k1)

    def kernel(n, c, v, b):
        return label_prop.label_propagate(
            n, c, v, *gate, bound=b, max_iters=params.label_prop_iters
        )

    def plain(n, c, v, b):
        del b
        with jax.default_matmul_precision("highest"):
            aff = faces._pairwise_affinity(n, c, v, *gate)
        return faces._label_propagate(aff, v, params.label_prop_iters)

    return jax.jit(jax.vmap(kernel)), jax.jit(jax.vmap(plain))


def _predicate_margin(n, c, v, rows, params):
    """Smallest float64 slack of the compare_normal/compare_plane
    predicates between the voxels ``rows`` and every valid voxel: how
    close to a threshold the pairs whose labels differ sit."""
    n, c = np.asarray(n, np.float64), np.asarray(c, np.float64)
    v = np.asarray(v)
    nh = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    cos_gate = np.cos(np.deg2rad(params.normal_thresh1))
    d = c[rows][:, None, :] - c[None, :, :]
    dist = np.linalg.norm(d, axis=-1)
    t = params.l1 / (params.k1 * dist + 1.0) * dist
    m1 = np.abs(np.einsum("ik,ijk->ij", n[rows], d))
    m2 = np.abs(np.einsum("jk,ijk->ij", n, d))
    slack = np.minimum.reduce([
        np.abs(nh[rows] @ nh.T - cos_gate), np.abs(t - m1), np.abs(t - m2),
    ])
    return float(slack[:, v].min())


def kernel_phase(name):
    (n, c, v, b), params = pass1_inputs(name)
    kernel, plain = label_prop_fns(params)
    lk = np.asarray(kernel(n, c, v, b))
    lp = np.asarray(plain(n, c, v, b))
    V = n.shape[1]
    n_diff = int((lk != lp).sum())
    k_ms = _steady_ms(kernel, n, c, v, b)
    p_ms = _steady_ms(plain, n, c, v, b)
    print(f"[kernel {name}] V={V} clouds={n.shape[0]} "
          f"occupied bound={np.asarray(b).tolist()} "
          f"components={[len(set(r[r < 2**30])) for r in lp]}")
    print(f"[kernel {name}] label_prop pass 1, 8 clouds: kernel "
          f"{k_ms[0]:.3f} ms (min {k_ms[1]:.3f}), plain XLA "
          f"{p_ms[0]:.3f} ms (min {p_ms[1]:.3f})")
    if n_diff:
        for i in np.flatnonzero((lk != lp).any(axis=1)):
            rows = np.flatnonzero(lk[i] != lp[i])
            margin = _predicate_margin(n[i], c[i], v[i], rows, params)
            print(f"[kernel {name}] cloud {i}: {len(rows)} labels differ; "
                  f"smallest predicate slack {margin:.3e}")
    _check(n_diff == 0, f"{n_diff} of {lk.size} labels differ at V={V}")


def pipeline_phase(name, batch=8):
    import bench
    import jax

    from fccf_pcr_tpu import make_register_fn, registration_errors

    cfg, params, caps = _preset(name)
    batches, T_gt = bench.make_batches(name, cfg, params, caps, batch)
    args = batches[0]
    n_pts = [int(np.asarray(m).sum(axis=1).mean()) for m in (args[1], args[3])]
    fn = make_register_fn(params, caps, batched=True)
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    res = compiled(*args)
    jax.block_until_ready(res)
    med, best = _steady_ms(compiled, *args)
    rre, rte = map(np.asarray, registration_errors(res.transform, T_gt))
    status = np.asarray(res.status)
    stats = jax.devices()[0].memory_stats() or {}
    gate = bench.GATES[name]
    print(f"[{name}] batch {batch}, mean downsampled points per cloud "
          f"src/tar {n_pts}, V={caps.max_voxels}")
    print(f"[{name}] compile {compile_s:.1f} s; steady step "
          f"{med:.2f} ms median, {best:.2f} ms min")
    print(f"[{name}] peak_bytes_in_use {stats.get('peak_bytes_in_use')}; "
          f"memory_analysis {compiled.memory_analysis()}")
    print(f"[{name}] RRE max {rre.max():.4f} deg, RTE max {rte.max():.4f} m "
          f"(gate {gate}); status {status.tolist()}")
    _check(bool((rre < gate[0]).all() and (rte < gate[1]).all()),
           f"{name} outside its gate {gate}")
    _check(not status.any(), f"{name} status bits {status.tolist()}")


def cli_phase():
    import bench

    from fccf_pcr_tpu import cli, registration_errors
    from fccf_pcr_tpu.io import ply

    cfg, params, _ = _preset("office")
    src, tar, T_gt = bench.pairs_for_config(cfg, [0])[0]
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, "src.ply"), os.path.join(d, "tar.ply")]
        ply.write_ply(paths[0], src)
        ply.write_ply(paths[1], tar)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([*paths, str(params.leaf_size), "--caps",
                           "eth-office", "--device", "gpu", "--json"])
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    T = np.asarray(rec["transform"], np.float64)
    _check(rc == 0 and T.shape == (4, 4) and np.isfinite(T).all(),
           f"CLI rc {rc}, transform {T}")
    rre, rte = map(float, registration_errors(T, np.asarray(T_gt, np.float64)))
    gate = bench.GATES["office"]
    print(f"[cli] RRE {rre:.4f} deg, RTE {rte:.4f} m (gate {gate}); "
          f"status {rec['status']}; register {rec['time_register_s']:.1f} s "
          "including compile")
    _check(rre < gate[0] and rte < gate[1], "CLI transform outside the gate")


def mesh_phase(n_chips, batch=8):
    """The office batch sharded over all ``n_chips`` visible GPUs (main
    has checked that there are that many) against device 0 alone."""
    import bench
    import jax

    from fccf_pcr_tpu import make_register_fn, registration_errors
    from fccf_pcr_tpu.parallel.mesh import make_mesh, make_sharded_register_fn

    devs = jax.devices()
    cfg, params, caps = _preset("office")
    batches, T_gt = bench.make_batches("office", cfg, params, caps, batch)
    args = batches[0]
    gate = bench.GATES["office"]

    sharded = make_sharded_register_fn(params, caps, make_mesh(devs))
    t0 = time.perf_counter()
    res_sh = sharded(*args)
    jax.block_until_ready(res_sh)
    first_sh = time.perf_counter() - t0
    spans = len(res_sh.transform.sharding.device_set)
    med_sh, _ = _steady_ms(sharded, *args)

    single = make_register_fn(params, caps, batched=True)
    args0 = jax.device_put(args, devs[0])
    t0 = time.perf_counter()
    res_1 = single(*args0)
    jax.block_until_ready(res_1)
    first_1 = time.perf_counter() - t0
    med_1, _ = _steady_ms(single, *args0)

    st_sh, st_1 = np.asarray(res_sh.status), np.asarray(res_1.status)
    T_sh, T_1 = np.asarray(res_sh.transform), np.asarray(res_1.transform)
    print(f"[mesh] sharded over {spans} devices: compile+first "
          f"{first_sh:.1f} s, steady {med_sh:.2f} ms; device 0 alone: "
          f"compile+first {first_1:.1f} s, steady {med_1:.2f} ms")
    print(f"[mesh] statuses sharded {st_sh.tolist()} single {st_1.tolist()}; "
          f"max |T_sharded - T_single| {np.abs(T_sh - T_1).max():.3e}")
    for tag, T in (("sharded", T_sh), ("single", T_1)):
        rre, rte = map(np.asarray, registration_errors(T, T_gt))
        print(f"[mesh] {tag}: RRE max {rre.max():.4f} deg, RTE max "
              f"{rte.max():.4f} m (gate {gate})")
        _check(bool((rre < gate[0]).all() and (rte < gate[1]).all()),
               f"{tag} run outside the office gate")
    _check(spans == n_chips, f"sharded output spans {spans} devices")
    _check(np.array_equal(st_sh, st_1), "statuses differ")
    _check(not st_sh.any(), f"status bits {st_sh.tolist()}")


def run_phases(phases):
    """Run (name, thunk) pairs in order; returns the names that failed."""
    failed = []
    for name, thunk in phases:
        t0 = time.perf_counter()
        try:
            thunk()
            print(f"PHASE {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:  # noqa: BLE001 - report, then fail the run
            traceback.print_exc()
            print(f"PHASE {name}: FAILED ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            failed.append(name)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=[1, 4], default=1,
                    help="4: run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU ({devs})", file=sys.stderr)
        return 1
    if len(devs) != args.chips:
        print(f"chip_smoke: --chips {args.chips} needs exactly {args.chips} "
              f"GPUs, JAX found {len(devs)} (set CUDA_VISIBLE_DEVICES)",
              file=sys.stderr)
        return 1
    try:
        import bench
        from fccf_pcr_tpu.utils.cache import setup_compile_cache
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 1

    print(bench.gpu_name_and_power_limit())
    print(f"jax {jax.__version__}; devices {devs}; compile cache "
          f"{setup_compile_cache()}", flush=True)
    if args.chips == 4:
        phases = [("mesh", lambda: mesh_phase(4))]
    else:
        phases = [
            ("office", lambda: pipeline_phase("office")),
            ("heritage", lambda: pipeline_phase("heritage")),
            ("kernel office", lambda: kernel_phase("office")),
            ("kernel heritage", lambda: kernel_phase("heritage")),
            ("cli", cli_phase),
        ]
    failed = run_phases(phases)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

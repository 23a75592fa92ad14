"""Measure per-stage content statistics of a scene family.

Capacity presets (models/fccf.py) must be sized from MEASURED content, not
guesses (the VoxelGrid/octree stages of the reference are dynamically
sized, FCCF.cpp:475-534/1370-1430; here every stage is a fixed-shape
masked tensor whose bound either wastes sort volume or drops content).
This tool runs the pipeline's stages at deliberately generous measurement
capacities on CPU and prints the content maxima a preset must cover:

    python tools/measure_content.py --scene courtyard --leaf 0.2 --seeds 8

Reported per scene family (max over seeds, both clouds):
  raw points, downsampled points, occupied feature voxels, faces,
  base matches, per-match third-plane hits, hypotheses, greedy seeds,
  emittable seeds (size >= 2), residual points, fine voxels, fine cell
  span (cells/axis at the 0.5 m fine voxel — >= 1024 would alias).
"""

import argparse
import sys

sys.path.insert(0, "/root/repo")

import numpy as np


def measure_pair(src, tar, params, caps):
    import jax
    import jax.numpy as jnp

    from fccf_pcr_tpu.cluster.cluster import _greedy_seeds_all_types
    from fccf_pcr_tpu.features.faces import faces_from_voxels
    from fccf_pcr_tpu.hypotheses.bases import select_bases
    from fccf_pcr_tpu.hypotheses.transforms import _match_one
    from fccf_pcr_tpu.io import synthetic
    from fccf_pcr_tpu.ops import geometry
    from fccf_pcr_tpu.ops.voxelize import compact, downsample_and_voxelize
    from fccf_pcr_tpu.pipeline.register import pre_downsample

    import time

    def tick(label, t=[None]):
        now = time.time()
        if t[0] is not None:
            print(f"#   {label}: {now - t[0]:.1f}s", file=sys.stderr)
        t[0] = now

    tick("start")
    out = {"raw": max(src.shape[0], tar.shape[0])}

    sp, sm = synthetic.pad_points(src, caps.raw_points)
    tp, tm = synthetic.pad_points(tar, caps.raw_points)
    if src.shape[0] > caps.raw_points or tar.shape[0] > caps.raw_points:
        out["raw_truncated"] = True

    pre = jax.jit(lambda p, m: pre_downsample(p, m, params, caps))
    clouds = []
    down_max = 0
    for p, m in ((sp, sm), (tp, tm)):
        dp, dm, ovf = pre(jnp.asarray(p), jnp.asarray(m))
        assert not bool(ovf), "measurement caps too small for downsample"
        down_max = max(down_max, int(jnp.sum(dm)))
        clouds.append((dp, dm))
    out["down"] = down_max
    tick("pre_downsample")

    per_cloud = []
    with jax.default_matmul_precision("highest"):
        for dp, dm in clouds:
            d, _, vs, pv, vstart = downsample_and_voxelize(
                dp, dm, params.leaf_size, params.face_voxel_size,
                caps.max_voxels, wide_extent=caps.wide_extent,
            )
            assert not bool(vs.overflow), "measurement max_voxels too small"
            faces, (res_pts, res_mask), _ = faces_from_voxels(
                vs, d, pv, params, caps
            )
            per_cloud.append((faces, res_pts, res_mask))
            out["voxels"] = max(out.get("voxels", 0), int(jnp.sum(vs.valid)))
            out["faces"] = max(out.get("faces", 0), int(jnp.sum(faces.valid)))
            out["residual"] = max(
                out.get("residual", 0), int(jnp.sum(res_mask))
            )
            tick("faces")

        (f1, r1_pts, r1_mask), (f2, r2_pts, r2_mask) = per_cloud[1], per_cloud[0]
        b1 = select_bases(f1, params)
        b2 = select_bases(f2, params)

        # Base matching + third-plane fan-out (same predicates as
        # hypotheses.transforms.generate_hypotheses, measurement-sized).
        B = b1.valid.shape[0]
        match = (
            b1.valid[:, None]
            & b2.valid[None, :]
            & (jnp.abs(b1.angle[:, None] - b2.angle[None, :]) < params.angle_same)
            & (b1.type_[:, None] == b2.type_[None, :])
        )
        out["matches"] = int(jnp.sum(match))
        M = caps.max_matches
        assert out["matches"] <= M, "measurement max_matches too small"
        bi1 = jnp.broadcast_to(b1.i[:, None], (B, B))
        bj1 = jnp.broadcast_to(b1.j[:, None], (B, B))
        bi2 = jnp.broadcast_to(b2.i[None, :], (B, B))
        bj2 = jnp.broadcast_to(b2.j[None, :], (B, B))
        _, _, m_valid, mi1, mj1, mi2, mj2 = compact(match, M, bi1, bj1, bi2, bj2)
        quat, T3, pair_ok, t_fb, fb = jax.vmap(
            lambda a, b, c, d: _match_one(f1, f2, a, b, c, d, params)
        )(mi1, mj1, mi2, mj2)
        hits = jnp.sum(pair_ok & m_valid[:, None, None], axis=(1, 2))
        tick("match_one")
        out["per_match_hits"] = int(jnp.max(hits))
        n_hyp = int(jnp.sum(hits) + jnp.sum(fb & m_valid))
        out["hypotheses"] = n_hyp

        # Cluster seeds: run the production seed scan at measurement H.
        F = f1.valid.shape[0]
        S = F * F + 1
        slot_valid = jnp.concatenate(
            [
                (pair_ok & m_valid[:, None, None]).reshape(M, F * F),
                (fb & m_valid)[:, None],
            ],
            axis=1,
        )
        slot_t = jnp.concatenate(
            [T3.reshape(M, F * F, 3), t_fb[:, None, :]], axis=1
        )
        H = caps.max_hypotheses
        hv = slot_valid.reshape(-1)
        _, h_ovf, h_valid, ht, hq = compact(
            hv, H, slot_t.reshape(-1, 3),
            jnp.repeat(quat, S, axis=0).reshape(-1, 4),
        )
        assert not bool(h_ovf), "measurement max_hypotheses too small"
        # type of each hypothesis = type of its match row
        btype = jnp.broadcast_to(b1.type_[:, None], (B, B))
        _, _, _, mtype = compact(match, M, btype)
        htype_flat = jnp.repeat(mtype, S)
        _, _, _, htype = compact(hv, H, htype_flat)
        types = jnp.arange(3, dtype=jnp.int32)
        masks = h_valid[None, :] & (htype[None, :] == types[:, None])
        px = geometry.quat_rotate(hq, jnp.broadcast_to(
            jnp.array([1.0, 0.0, 0.0]), (H, 3)))
        py = geometry.quat_rotate(hq, jnp.broadcast_to(
            jnp.array([0.0, 1.0, 0.0]), (H, 3)))
        seeds, size_all, _ = _greedy_seeds_all_types(masks, ht, px, py, params)
        tick("seed_scan")
        out["seeds"] = int(jnp.max(jnp.sum(seeds, axis=1)))
        out["emittable_seeds"] = int(
            jnp.max(jnp.sum(seeds & (size_all >= 2.0), axis=1))
        )

        # Fine-verify source-table content: distinct cells + span.
        for pts, msk in ((r1_pts, r1_mask), (r2_pts, r2_mask)):
            cells = np.floor(
                np.asarray(pts)[np.asarray(msk)] / params.fine_voxel
            ).astype(np.int64)
            if cells.size:
                out["fine_voxels"] = max(
                    out.get("fine_voxels", 0),
                    len(np.unique(
                        (cells[:, 0] << 42) ^ (cells[:, 1] << 21) ^ cells[:, 2]
                    )),
                )
                out["fine_span_cells"] = max(
                    out.get("fine_span_cells", 0),
                    int((cells.max(0) - cells.min(0) + 1).max()),
                )
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from fccf_pcr_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    from fccf_pcr_tpu.config import Capacities, FCCFParams
    from fccf_pcr_tpu.io import synthetic

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True, choices=sorted(synthetic.SCENES))
    ap.add_argument("--leaf", type=float, default=0.1)
    ap.add_argument("--face-voxel", type=float, default=None,
                    help="feature voxel size (m); default 1.0 (reference)")
    ap.add_argument("--fine-voxel", type=float, default=None,
                    help="fine-verify voxel size (m); default 0.5")
    ap.add_argument("--max-voxels", type=int, default=1 << 14,
                    help="measurement voxel capacity (CPU cost is O(V^2); "
                         "size near expected content, the overflow assert "
                         "catches undersizing)")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--max-angle", type=float, default=40.0)
    ap.add_argument("--max-trans", type=float, default=3.0)
    ap.add_argument("--dropout", type=float, default=0.15)
    ap.add_argument("--scene-kw", default="",
                    help="comma k=v scene kwargs (floats/ints)")
    args = ap.parse_args()

    scene_kw = {}
    for kv in filter(None, args.scene_kw.split(",")):
        k, v = kv.split("=")
        scene_kw[k] = float(v) if "." in v else int(v)

    pkw = {"leaf_size": args.leaf}
    if args.face_voxel is not None:
        pkw["face_voxel_size"] = args.face_voxel
    if args.fine_voxel is not None:
        pkw["fine_voxel"] = args.fine_voxel
    params = FCCFParams(**pkw)
    # Generous measurement capacities — big enough that nothing truncates.
    caps = Capacities(
        max_points=1 << 19,
        max_raw_points=1 << 20,
        max_voxels=args.max_voxels,
        max_matches=8192,
        max_hypotheses=1 << 14,
        max_reps=512,
        max_clusters=8192,
        max_residual=1 << 18,
        max_fine_voxels=1 << 17,
        per_match_hits=257,
        wide_extent=True,
    )

    agg = {}
    for seed in range(args.seeds):
        src, tar, _ = synthetic.make_pair(
            seed=seed, scene=args.scene, max_angle_deg=args.max_angle,
            max_trans=args.max_trans, dropout=args.dropout, **scene_kw,
        )
        m = measure_pair(src, tar, params, caps)
        print(f"# seed {seed}: {m}", file=sys.stderr)
        for k, v in m.items():
            agg[k] = max(agg.get(k, 0), v)
    print({"scene": args.scene, "leaf": args.leaf, "seeds": args.seeds,
           "max": agg})


if __name__ == "__main__":
    main()

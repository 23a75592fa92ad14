"""Parameter and capacity configuration for the FCCF-PCR JAX pipeline.

Mirrors the reference's file-scope global parameter set
(``/root/reference/FCCF.cpp:120-176``) as a frozen, hashable dataclass so a
whole parameter set can be closed over statically by ``jax.jit``.

Capacities are this rebuild's addition: every pipeline stage operates on
fixed-shape, masked tensors (max points N, max voxels V, max faces F, ...);
these bounds are chosen per-dataset and are static under ``jit``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FCCFParams:
    """Algorithm parameters. Defaults are bit-identical to the reference
    except ``curvature_threshold`` (see the field comment: a measured,
    intentional accuracy divergence; ``--set curvature_threshold=0.05``
    restores the reference value).

    Field-by-field provenance (reference ``FCCF.cpp`` line numbers):
      l1/l2/k1/k2            :126-129   plane-fusion coplanarity params
      normal_thresh1/2       :131-132   normal-angle gates (deg) for growth/merge
      face_voxel_size        :134       feature octree resolution (m)
      voxel_point_threshold  :136       per-voxel min point count (strictly >)
      curvature_threshold    :138       plane-fit curvature gate
      select_plane_number    :141       top-K faces kept (loop keeps K+1, see :655-675)
      qv_angle / qv_dist     :145-146   quick-verify coplanarity gates
      required_optimize      :147       min pairs to trigger refinement
      fine_voxel             :150       fine-verify octree resolution (m)
      fine_verify_number     :151       candidates fine-verified per type
      angle_same             :156       base included-angle match gate (deg)
      angle_min / angle_max  :157-158   base included-angle window (deg)
      third_plane_threshold  :160       |(n1xm1).n3| spanning gate
      third_normal_threshold :162       third-plane normal-angle gate (deg)
      cluster_count_threshold:166       <=10 hypotheses -> pass-through
      cluster_angle          :167       rotation cluster gate (deg)
      cluster_dist           :168       translation cluster radius (m)
      select_cluster_number  :171       cluster budget scale (200)
      rough_threshold        :175       smooth/rough face classification
      leaf_size              :176,1650  voxel-grid downsample leaf (CLI arg)
    """

    l1: float = 0.5
    l2: float = 1.0
    k1: float = 5.0
    k2: float = 2.0
    normal_thresh1: float = 5.0
    normal_thresh2: float = 8.0
    face_voxel_size: float = 1.0
    voxel_point_threshold: int = 5
    # Plane-fit curvature gate (lambda_min / trace of the per-voxel
    # covariance). The reference uses 0.05 (FCCF.cpp:138); that is far too
    # loose for voxels straddling plane junctions: on the stairs family
    # 44/205 gated voxels carried normals >1 deg off their plane at median
    # curvature 0.017 (count-weighted mean normal error 2.5 deg), biasing
    # every downstream face normal. Junction voxels and clean single-plane
    # voxels are separated by ~two orders of magnitude in curvature
    # (~0.017 vs ~1e-4), so 0.005 removes the contaminated voxels while
    # keeping 80% of the population (weighted normal error 2.53 -> 0.074
    # deg). Measured on-chip over the full 6-family x 40-seed sweep
    # (240/240 success, zero flagged, throughput unchanged,
    # docs/EVALUATION.md): RRE mean improved on every family — structured
    # 0.457 -> 0.053 deg (p95 1.060 -> 0.112), office 0.068 -> 0.023,
    # apartment 0.118 -> 0.016 — and RTE improved ~2-3x everywhere. The
    # NumPy twin (reference semantics) improves identically, so this is an
    # algorithm-level parameter fix, not an implementation artifact.
    # Documented as PARITY.md divergence 9; set 0.05 to restore the
    # reference default.
    curvature_threshold: float = 0.005
    select_plane_number: int = 15
    qv_angle: float = 10.0
    qv_dist: float = 2.0
    required_optimize: int = 4
    fine_voxel: float = 0.5
    fine_verify_number: int = 4
    angle_same: float = 5.0
    angle_min: float = 30.0
    angle_max: float = 150.0
    third_plane_threshold: float = 0.5
    third_normal_threshold: float = 5.0
    cluster_count_threshold: int = 10
    cluster_angle: float = 2.0
    cluster_dist: float = 0.8
    select_cluster_number: int = 200
    rough_threshold: float = 2.0
    leaf_size: float = 0.1
    # --- knobs with no reference counterpart ---
    # Gauss-Newton/LM iterations replacing Ceres DENSE_QR max 50 (:227).
    refine_iters: int = 50
    # Label-propagation sweeps cap for face growth (converges much earlier).
    label_prop_iters: int = 32
    # Type-gate in the final fusion (:1601).
    fuse_gate: float = 0.8
    # Rotation-consistency gate for fusion (degrees; 0 = off = the
    # reference's blind average of all kept types' rotations,
    # FCCF.cpp:1599-1606). A degenerate type whose single candidate is
    # rotated off the true pose can clear the 0.8 score gate purely on
    # fine score (its quick score near zero) and corrupt the average —
    # measured on a facade pair (8.9 deg final error from two 13.8-deg
    # types) and on one apartment pair. Correct types always agree within
    # ~1 deg, so 10 deg keeps every healthy fusion unchanged while
    # dropping corrupted ones. DEFAULT ON at 10: a 6-family x 40-seed
    # sweep (240 pairs, docs/EVALUATION.md) is 240/240 successful with
    # mean RRE improved on every family vs the blind average (intentional,
    # documented accuracy divergence from the reference; set 0 to restore
    # reference-faithful fusion).
    fuse_rotation_gate_deg: float = 10.0
    # A refine_fine_guard{,_margin} knob pair ("keep the better of the
    # pre-/post-refinement pose by fine score") lived here rounds 3-4 and
    # was deleted round 5 after its accuracy A/B under the 0.005
    # curvature gate measured it worse on every metric (docs/PARITY.md
    # divergence 8).

    def replace(self, **kw) -> "FCCFParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Static shape bounds for the masked tensor pipeline.

    The reference uses dynamic ``std::vector`` everywhere; here every
    stage is a fixed-shape program. Overflow degrades gracefully: smallest /
    latest entries are dropped and a status flag is raised.
    """

    max_points: int = 1 << 18     # points per cloud entering register_pair
    max_voxels: int = 4096        # occupied 1m feature voxels per cloud
    max_faces: int = 16           # top-15(+1) faces kept (:655-675)
    max_matches: int = 2048       # compatible (base1, base2) pairs
    max_hypotheses: int = 8192    # closed-form transform hypotheses (all types)
    max_reps: int = 256           # cluster representatives per type (<=201 used)
    max_clusters: int = 2048      # sorted seed clusters walked during emission
    max_residual: int = 1 << 16   # residual (non-planar) points kept per cloud
    # Third-plane hits extracted per base match before global compaction
    # (hypotheses/transforms.py two-stage extraction). Measured maxima
    # (tools/measure_content.py, 8 seeds/family at bench geometry):
    # indoor rooms <= 9, stair flights <= 12, pillar halls <= 11,
    # building courtyards <= 14 (colonnade parallel-plane fan-out; the
    # heritage preset raises this to 24). Extras beyond the bound are
    # dropped in reference enumeration order and flag overflow. (An
    # earlier "up to 21 on pillar halls" measurement predated the
    # round-2 scene-generator orientation fix and is obsolete.)
    per_match_hits: int = 16
    max_fine_voxels: int = 1 << 15  # occupied 0.5m voxels in fine verify
    # Raw-load capacity for the CLI-level pre-downsample (FCCF.cpp:1668-1678,
    # which runs OUTSIDE the reference's timed region :1681-1685). 0 means
    # "same as max_points". Presets size max_points to the post-downsample
    # content so the hot pipeline never pays for raw-cloud padding.
    max_raw_points: int = 0
    # Fused voxelization key layout: False = single combined sort key
    # (fastest; face-cell extent limited to what remains of 31 bits after
    # the within-face leaf index — e.g. 127 m per axis at leaf 0.1 / face
    # 1.0). True = separate two-key sort with the full 2047x1023x1022-cell
    # face extent, for building-scale scenes (resso/heritage presets).
    wide_extent: bool = False

    @property
    def raw_points(self) -> int:
        return self.max_raw_points or self.max_points

    @property
    def max_bases(self) -> int:
        f = self.max_faces
        return f * (f - 1) // 2

    def replace(self, **kw) -> "Capacities":
        return dataclasses.replace(self, **kw)


# Small capacities for CPU tests: keep compile times low.
TEST_CAPS = Capacities(
    max_points=8192,
    max_voxels=1024,
    max_faces=16,
    max_matches=1024,
    max_hypotheses=2048,
    # The adaptive floor walk can emit up to select_cluster_number+1 = 201
    # representatives per type (FCCF.cpp:1208-1211); anything smaller
    # truncates the reference semantics (and flags STATUS_REP_OVERFLOW).
    max_reps=256,
    max_clusters=256,
    max_residual=2048,
    max_fine_voxels=2048,
)

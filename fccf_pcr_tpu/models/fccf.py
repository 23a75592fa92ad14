"""Model registry: named pipeline configurations.

The reference is a single hard-coded parameterization (FCCF.cpp:120-176)
tuned per dataset only through the CLI leaf size (README.md:17). The
framework's "model family" equivalent is a registry of (params, capacities)
presets sized for the benchmark configurations in BASELINE.md / BASELINE.json:

  eth-office      ETH "Office", 0.1 m leaf (README demo config)
  eth-apartment   ETH "Apartment", 0.05 m leaf (denser indoor)
  eth-structured  Stairs + Hauptgebaude mixed batches (small-plane flights
                  and building-scale halls in one vmap batch)
  eth-outdoor     Gazebo/Wood cross-season (larger extents, more clutter)
  resso           RESSO scenes (building-scale)
  heritage        Heritage (largest scene in Table I)
  tiny            CI/test-sized
"""

from __future__ import annotations

import dataclasses

from ..config import Capacities, FCCFParams, TEST_CAPS


@dataclasses.dataclass(frozen=True)
class FCCFModel:
    """A named, fully-specified registration pipeline configuration."""

    name: str
    params: FCCFParams
    caps: Capacities

    def make_fn(self, batched: bool = False):
        from ..pipeline.register import make_register_fn

        return make_register_fn(self.params, self.caps, batched=batched)


# Capacity presets are sized from measured content statistics of the
# benchmark scene families (tools/measure_content.py). Stage capacities
# (voxels/hypotheses/residual/fine) carry >= 1.4x headroom over observed
# maxima; the point capacities are tighter (~1.07x — they set the hot
# sort volume directly). EVERY bound is guarded at runtime: stage
# overflow raises a status bit, and pre_downsample's truncation flag is
# surfaced by every caller (CLI warning + record field, sweep records,
# bench/evaluate hard-fail). max_points is the POST-pre-downsample
# capacity (the hot pipeline's sort volume); max_raw_points is the
# raw-load capacity consumed by the untimed CLI-level first VoxelGrid
# pass (pre_downsample).
_STANDARD_CAPS = Capacities(      # office at the 0.005 curvature default
    max_points=1 << 16,           # (8 bench seeds, measure_content.py):
    max_raw_points=1 << 17,       #   raw<=124k, down<=60.5k, vox<=1019,
    max_voxels=1536,              #   match<=939, hyp<=1236, res<=19.2k,
    # match/hyp lanes run TIGHT over the bench-seed maxima: the sort
    # volume they set is what the stages cost, and accuracy is
    # bit-identical. The 0.005 curvature gate shrank office match content
    # to <=939, so match is 1024 = 1.09x over the bench-seed maximum.
    # Whether the tight lanes pay on the GPU is ROADMAP S6/D6. They are
    # policy-legal only because overflow raises a status bit and sweep
    # drivers re-run flagged pairs at auto_escalation_caps
    # (evaluate.py --escalate-caps auto).
    max_matches=1024,
    max_hypotheses=2048,
    max_reps=256,
    max_clusters=2048,
    # Residual feeds the fine-verify join (12 sorted joins of
    # max_fine_voxels + max_residual rows per pair) — the tightest
    # policy-compliant bound (>= 1.4x measured) cuts dead sort rows.
    max_residual=28672,
    max_fine_voxels=2048,
)

_DENSE_CAPS = dataclasses.replace(  # apartment at the 0.005 gate:
    _STANDARD_CAPS,                 #   raw<=248k, down<=122k, vox<=482,
    max_points=1 << 17,             #   match<=829, hyp<=1015, res<=62.0k
    max_raw_points=1 << 18,         #   (1.06x under the 65536 cap — 40
    max_voxels=1024,                #   eval seeds pass unescalated),
                                    #   fine<=1328
    max_hypotheses=4096,
    max_residual=1 << 16,
    max_fine_voxels=2048,
)

_STRUCTURED_CAPS = dataclasses.replace(  # measured at the 0.005 curvature
    _STANDARD_CAPS,                      # default (8 bench seeds/family,
    max_points=98304,                    # tools/measure_content.py):
    max_raw_points=147456,               # stairs: raw<=112k, down<=31k,
    max_voxels=4096,                     #   vox<=257, hyp<=472, res<=14.6k
    max_matches=4096,                    # hall: raw<=132k, down<=91.4k,
    max_hypotheses=8192,                 #   vox<=2820, match<=3525,
    max_clusters=6144,                   #   hyp<=7570, seeds<=4315,
    max_residual=28672,                  #   res<=26.8k, fine<=2964,
    max_fine_voxels=4096,                #   <=13 hits/match.
    # The cleaner normals of the tight curvature gate nearly DOUBLE the
    # hall family's match/hypothesis content (more bases clear the angle
    # gates): hyp 4177 -> 7570, seeds -> 4315, which overflowed the old
    # 6144/4096 lanes (9/40 eval seeds escalated). match/res lanes stay
    # tight (1.16x/1.07x over bench maxima; sort volume is what costs) —
    # sweeps pair them with --escalate-caps auto like every tight lane.
)

_OUTDOOR_CAPS = dataclasses.replace(  # cross-season at the 0.005 gate
    _STANDARD_CAPS,                   #   (8 bench seeds): raw<=102k,
    max_raw_points=1 << 18,           #   down<=57k, vox<=1042, match<=929,
    # tight lanes (identical accuracy); the tight gate nearly HALVED
    # match/hyp content here (hyp 2238 -> 1106 max), so the 2048/2560
    # lanes now carry ~2x headroom; escalation covers any eval tail (see
    # _STANDARD_CAPS note).
    max_matches=2048,
    max_hypotheses=2560,
    max_residual=28672,               # res<=22.2k (1.29x under the cap)
    max_fine_voxels=2048,             # fine<=1476
)

_RESSO_CAPS = Capacities(   # facade family at the 0.005 gate (8 bench
    max_points=73728,       #   seeds, measure_content.py): raw<=73.0k,
    max_raw_points=81920,   #   down<=68.9k, vox<=6639, match<=1132 (f32
    max_voxels=9216,        #   face tie-flips can shift counts),
    # match/hyp 1536: 1.36x/1.21x over the bench maxima at identical
    # accuracy; escalation covers the eval tail as ever.
    max_matches=1536,       #   hyp<=1273,
    max_hypotheses=1536,    #   <=6 hits/match, res<=6.9k, fine<=1226,
    max_reps=256,           #   span<=118 cells
    max_clusters=1024,
    max_residual=10240,     # 1.49x over the 6.9k measured max
    max_fine_voxels=4096,
    wide_extent=True,       # RESSO blocks can span past the ~127 m
)                           #   single-key budget (leaf 0.1 / face 1.0)

_HERITAGE_CAPS = Capacities(  # courtyard family (measure_content, 8
    max_points=245760,        #   seeds, leaf 0.2 / face 2.0): raw<=283k,
    max_raw_points=294912,    #   down<=238k, vox<=8526, match<=960,
    # 9216 = 1.08x over the observed 8526 voxel max (the plain path's
    # O(V^2) label-prop work scales with this cap) at identical accuracy;
    # overflow is flagged + escalated like every other bound.
    max_voxels=9216,          #   match<=1748, hyp<=2599, seeds<=1992,
    max_matches=2048,         #   res<=34.9k (36.5k 40-seed eval max at
    max_hypotheses=3072,      #   the old gate), fine<=15.2k, span<=283
    max_reps=256,             #   cells (0.5 m fine voxel, no aliasing).
    max_clusters=2048,        # Colonnade parallel-plane fan-out reaches
    max_residual=53248,       #   30 third-plane hits on one match (eval
    per_match_hits=48,        #   seed 38, old gate; 17 at 0.005) — 48.
    max_fine_voxels=1 << 15,  # res 1.53x over the bench maximum
    wide_extent=True,
)

REGISTRY = {
    "eth-office": FCCFModel(
        "eth-office", FCCFParams(leaf_size=0.1), _STANDARD_CAPS
    ),
    "eth-apartment": FCCFModel(
        "eth-apartment", FCCFParams(leaf_size=0.05), _DENSE_CAPS
    ),
    "eth-structured": FCCFModel(
        "eth-structured", FCCFParams(leaf_size=0.1), _STRUCTURED_CAPS
    ),
    "eth-outdoor": FCCFModel(
        "eth-outdoor", FCCFParams(leaf_size=0.1), _OUTDOOR_CAPS
    ),
    # Building-scale presets. The heritage feature voxel scales with its
    # leaf (2.0 m at 0.2 m leaf, the same 10x ratio as office) — the
    # reference hard-codes 1 m (FCCF.cpp:134) because it never re-tunes
    # per dataset beyond the CLI leaf; at a >100 m extent a 1 m feature
    # grid yields ~21k voxels of O(V^2) face-growth work for no accuracy
    # gain over coarser plane patches.
    "resso": FCCFModel("resso", FCCFParams(leaf_size=0.1), _RESSO_CAPS),
    "heritage": FCCFModel(
        "heritage",
        FCCFParams(leaf_size=0.2, face_voxel_size=2.0),
        _HERITAGE_CAPS,
    ),
    "tiny": FCCFModel("tiny", FCCFParams(leaf_size=0.25), TEST_CAPS),
}


def get_model(name: str) -> FCCFModel:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]

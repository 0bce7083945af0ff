"""Typed configuration of the PyTorch + CUDA port.

The port's own copy of the JAX package's four dataclasses
(burn_raymarching_tpu/config.py): the same field names, defaults,
validation and helper methods, so the CLIs keep their flags and a
configuration means the same in both packages. Nothing is shared:
tests/test_torch_config_utils.py holds the two copies against each other.
In the port ``use_pallas`` means "use the hand-written CUDA kernels";
``steps_per_call`` is the chunk of steps between host reads (train/loop.py)
and ``scan_unroll`` the number of steps recorded in one CUDA graph
(train/chunk.py), where the JAX package has one compiled scan of that many
steps and its unroll factor.

The original hardcodes every hyperparameter as a compile-time constant
(reference: src/bin/train.rs:30,128-131,161-166,174-176,193-197 and
src/training.rs:24-31,51,55,62-70,82). Here they live in one dataclass with
those values as defaults, CLI-overridable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer constants (reference: src/renderer_diff.rs, src/renderer.rs)."""

    march_steps: int = 40           # sphere-tracing iterations (renderer_diff.rs:22)
    softmax_sharpness: float = 10.0  # compositor temp: softmax(-10*d) (renderer_diff.rs:74)
    mask_sharpness: float = 15.0     # coverage: sigmoid(-15*sdf) (renderer_diff.rs:88)
    normal_eps: float = 1e-4         # central-difference step (scene.rs:90)
    gt_smooth_k: float = 32.0        # GT renderer fixed soft-min k (renderer.rs:21)
    gt_light_dir: tuple = (-0.5, 0.5, -1.0)  # fixed GT light (renderer.rs:27)
    gt_ambient: float = 0.1          # GT lighting = diffuse + 0.1 (renderer.rs:40)
    gt_weight_sharpness: float = 10.0  # GT compositor exp(-10*d) (renderer.rs:52)
    gt_mask_sharpness: float = 10.0    # GT mask exp(-10*d^2) (renderer.rs:77)
    # --- extension of the original (no reference counterpart, default off) ---
    # Pixel-footprint-adaptive coverage: the fixed sigmoid(-sharpness*d)
    # transition has constant WORLD-space width 1/sharpness, i.e. its
    # screen-space softness varies with depth and resolution (the measured
    # pathology-2/3 wall: docs/SCALING.md). With mask_pixel_mult > 0 the
    # transition width becomes max(1/mask_sharpness,
    # mask_pixel_mult * pixel_angle * t) — never sharper than the
    # configured sharpness, never narrower than ~mask_pixel_mult pixels on
    # screen. pixel_angle is the per-pixel view angle in radians
    # (2*tan(fov/2)/height); callers that know the camera set it
    # (scripts/run_c5.py --mask-px does this automatically).
    mask_pixel_mult: float = 0.0
    pixel_angle: float = 0.0
    # Coverage FAMILY: "sigmoid" = the reference's trainable silhouette
    # sigmoid(-mask_sharpness*d) (renderer_diff.rs:86-90). "gaussian" =
    # exp(-mask_sharpness*d^2), the GT renderer's own mask family
    # (renderer.rs:77) — the reference trains a sigmoid against
    # Gaussian-masked targets and that mismatch is baked into the measured
    # representational ceilings at configs 4-5 (docs/SCALING.md). Opt-in;
    # gradient topology is unchanged (coverage is still a function of the
    # reattached scene distance only).
    coverage_mode: str = "sigmoid"
    # Pixel-footprint-INTEGRATED training forward (extension of the original,
    # default 1 = the reference's point-sampled renderer): render each
    # training pixel as `supersample` sub-pixel-jittered rays (fixed
    # cell-centered grid over the pixel footprint, derived from
    # pixel_angle) and average the PREDICTION before the loss. The
    # round-3 error decomposition pins 69-84% of residual error to a
    # ±2 px silhouette band where point-sampled coverage makes sub-pixel
    # geometry first-order invisible (pathology 3); area-averaging gives
    # the silhouette a gradient from the whole footprint. Costs
    # supersample× field evaluations per unique pixel (the step keeps its
    # TOTAL ray count: batch/supersample unique pixels per step). Meant to
    # be ANNEALED per stage via TrainConfig.supersample_stages, ending at
    # 1 so the trained forward matches the point-sampled evaluator.
    supersample: int = 1


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss term coefficients (reference: src/training.rs:8-85)."""

    fg_weight: float = 10.0          # object-region L1 weight (training.rs:31)
    bg_weight_start: float = 1.0     # background weight at progress=0 (training.rs:26)
    bg_weight_end: float = 5.0       # background weight at progress=1 (training.rs:26)
    fg_mask_threshold: float = 0.01  # target color sum for "object" (training.rs:22)
    radius_large_coeff: float = 0.04   # (training.rs:51)
    radius_l1_coeff: float = 0.002     # (training.rs:51)
    center_coeff: float = 0.05         # origin attraction (training.rs:55)
    proximity_bound: float = 1.2       # camera-proximity barrier radius (training.rs:62)
    proximity_coeff: float = 5.0       # (training.rs:70)
    repulsion_coeff: float = 1e-5      # pairwise repulsion (training.rs:82)
    # Far-field treatment of the two-level (cluster_repulsion) term:
    #   "member"   — every member interacts with every far-cluster centroid
    #                ([M, C] pairs; grad cosine ~0.993 vs the exact sum);
    #   "monopole" — centroid↔centroid only ([C, C] pairs, ~G× fewer —
    #                measured ~0.7 ms/step cheaper at M=51k — grad cosine
    #                ~0.978). The exact near field is identical in both.
    repulsion_far_field: str = "member"
    # --- extension of the original (default OFF = reference parity) ---
    # Extra multiplier on the DIM SILHOUETTE FRINGE: object pixels whose
    # target luminance sum is in (fg_mask_threshold, fringe_threshold).
    # Round-3 error decomposition (scripts/diag_error_decomp.py) measured
    # 69-84% of the trained scenes' residual squared error in the ±2 px
    # silhouette band at ~16 dB local PSNR while interiors sit at ~28.5 —
    # the soft-mask fringe is exactly the low-target-luminance band, so a
    # value-based weight reaches it with no spatial plumbing. Applies on
    # top of fg_weight (training.rs:24-31 semantics otherwise unchanged).
    fringe_weight: float = 1.0
    fringe_threshold: float = 0.3


@dataclasses.dataclass(frozen=True)
class DensityConfig:
    """Prune/split rules (reference: src/training.rs:87-238)."""

    prune_min_radius: float = 0.005      # (training.rs:167)
    prune_max_radius_base: float = 1.0   # r > 1 - 0.04*stage culled (training.rs:167)
    prune_max_radius_decay: float = 0.04
    prune_flyaway_dist_sq: float = 1.44  # ||c||^2 > 1.2^2 (training.rs:171-174)
    prune_black_color_sum: float = 0.05  # (training.rs:177-180)
    split_radius_base: float = 0.25      # threshold 0.25*0.65^stage (training.rs:187)
    split_radius_decay: float = 0.65
    split_move_dist: float = 0.05        # move^2 > 0.05^2 (training.rs:188)
    split_child_radius_scale: float = 0.8  # (training.rs:203)
    split_child_min_radius: float = 0.01
    # --- Scale-aware split (extension of the original, default OFF) ---
    # The reference's absolute split threshold (0.25*0.65^stage,
    # training.rs:187) never fires on prior-seeded compact clouds (radii
    # ~0.02-0.1), so density control can only SHRINK configs 4-5 — the
    # grow-by-splitting dynamic is dead exactly where the committed runs sit
    # below their ceiling (VERDICT r2). split_mode="residual" replaces the
    # radius/move criterion with residual attribution through the compositor
    # weights (train/residual.py): at each boundary the rules run
    # prune → overlap-merge → split the top-``split_budget`` scorers
    # (merge BEFORE split so fresh children are not immediately re-merged;
    # the reference mode keeps its committed split-then-merge order).
    # split_budget 0 = auto (split_frac of the kept rows).
    split_mode: str = "reference"    # "reference" | "residual"
    split_budget: int = 0
    split_frac: float = 0.25
    # Pixel subsample for the boundary scoring pass (train/residual.py).
    split_score_pixels: int = 1 << 21
    # extension of the original (no reference counterpart; default OFF): merge
    # primitives sharing a Morton grid cell of this size at stage
    # boundaries. Prior-seeded 50k clouds stack ~25 primitives per SfM
    # point; the stack renders as ONE inflated blob (soft-min of n equal
    # distances ≈ d − ln(n)/k) while multiplying every per-tile qualifying
    # set. Merging keeps the represented surface (largest member radius,
    # weight-averaged center/color) and compacts N like 3DGS's own
    # duplicate cleanup.
    merge_cell: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training schedule (reference: src/bin/train.rs)."""

    batch_size: int = 16384          # rays/step (train.rs:30)
    width: int = 256
    height: int = 256
    stages: int = 5                  # (train.rs:128)
    steps_per_stage: int = 700       # (train.rs:129)
    max_smooth_k: float = 32.0       # (train.rs:131)
    min_smooth_k: float = 5.0        # anneal start (train.rs:174)
    uniform_ratio_start: float = 0.8  # (train.rs:176)
    uniform_ratio_end: float = 0.4
    base_lr: float = 0.05            # (train.rs:166)
    lr_stage_decay: float = 0.6      # base_lr * 0.6^stage
    lr_midstage_factor: float = 0.2  # step > steps/2 → lr*0.2 (train.rs:193-197)
    weight_decay: float = 1e-5       # Burn WeightDecayConfig (train.rs:162)
    # "folded" = Burn semantics (decay into the gradient before Adam's
    # moments). At hundreds+ of primitives this dissolves the scene — Adam
    # normalizes the decay to a full-lr drift on any coordinate without data
    # gradient; use "decoupled" (AdamW) for large-M configs. See
    # train/optimizer.py.
    weight_decay_mode: str = "folded"
    # Per-parameter-group learning-rate multipliers (x base LR schedule).
    # All 1.0 = reference parity. Many-small-primitive scenes need geometry
    # rates far below appearance rates: the loss landscape w.r.t. a tiny
    # primitive's center is a razor-thin, nearly flat valley (measured
    # same-batch line-search gain ~1e-5) and Adam's normalized steps
    # otherwise walk primitives onto the zero-gradient plateau, dissolving
    # the scene. Validated recipe for prior-seeded clouds:
    # centers 0.01, radii 0.1, colors/light 1.0 (with base_lr ~0.02).
    lr_scale_centers: float = 1.0
    lr_scale_colors: float = 1.0
    lr_scale_radii: float = 1.0
    lr_scale_light: float = 1.0
    # Per-STAGE coverage family (empty = cfg.render.coverage_mode
    # throughout). Entries index by stage, clamped to the last — e.g.
    # ("sigmoid", "gaussian") trains the stacked prior-seeded stage 0 under
    # the saturating sigmoid (whose interior is coverage-1 regardless of
    # depth-inside) and switches to the GT-matched Gaussian once the
    # overlap merge has collapsed the stacks (the Gaussian mask dims
    # interiors, which costs ~2.7 dB on the 25-deep stacked init —
    # docs/SCALING.md round 3). Changing the family changes the traced
    # program, so the trainer builds one jitted step per distinct mode.
    # Evaluation/preview/export always use the FINAL mode.
    coverage_mode_stages: tuple = ()
    # Per-STAGE coverage sharpness (same clamping/indexing; empty = the
    # constant render.mask_sharpness). Coarse-to-fine annealing: pathology
    # 3's center-gradient valleys have width ~1/mask_sharpness (sigmoid) or
    # ~1/sqrt(s) (gaussian) — soft early stages give geometry wide basins
    # to move in, late stages match the GT family/sharpness for the
    # representational ceiling. One jitted step program per distinct
    # (coverage, sharpness) pair.
    mask_sharpness_stages: tuple = ()
    # Per-STAGE supersample factor (empty = the constant
    # render.supersample; same clamping/indexing as the other stage
    # schedules). The silhouette-band optimization lever: middle stages
    # train against the pixel-footprint-averaged forward, the last
    # stage(s) anneal back to 1 = the point-sampled evaluator's forward
    # (the Trainer validates the schedule ends at render.supersample).
    supersample_stages: tuple = ()
    # Per-STAGE mask_pixel_mult (empty = the constant
    # render.mask_pixel_mult). The ANALYTIC pixel-area arm: a mid-run
    # stage can train under a coverage whose transition width is pinned to
    # the pixel footprint (sigmoid family + high mask_sharpness so the
    # pixel term binds — w = max(1/sharpness, mult*pixel_angle*t)), then
    # anneal back to the point-sampled family the targets were rendered
    # with. Must end at render.mask_pixel_mult.
    mask_px_stages: tuple = ()
    # Per-STAGE override of lr_scale_centers (empty = constant). The
    # committed compact-cloud recipes choose lr_scale_centers for the
    # ~25-deep stacked init; after the stage-1 overlap merge collapses the
    # cloud ~20x the same rate may be far from optimal — this lets the
    # post-merge stages re-tune geometry lr without a second script. Values
    # index by stage (clamped at the end, so polish inherits the last one).
    lr_scale_centers_stages: tuple = ()
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-5           # Burn AdamConfig default epsilon
    init_n: int = 7                  # initial primitive count (train.rs:103)
    init_offset: float = 0.1         # 6-direction layout scale (train.rs:111-121)
    init_ambient_logit: float = -1.4  # sigmoid(-1.4)≈0.2 (train.rs:108)
    # "reference": the 6-directions-plus-center layout (extras at origin).
    # "cloud": uniform random small-sphere cloud — the sane dense init for
    # large init_n (configs 4-5).
    init_layout: str = "reference"
    init_cloud_extent: float = 0.8
    init_cloud_radius: float = 0.03
    # Geometry prior for the cloud init: a JSON file {"points": [x,y,z,...]}
    # (COLMAP sparse points via tools/colmap_to_json --points-out, or the
    # generator's GT samples) — 3DGS-style SfM seeding.
    init_points: str = ""
    init_points_jitter: float = 0.02
    fg_pixel_threshold: float = 0.05  # dataset fg/bg split (dataset.rs:30)
    preview_chunk: int = 4096        # tiled inference chunk (train.rs:344)
    seed: int = 0
    use_pallas: bool = True          # the hand-written CUDA kernels
    dtype: str = "float32"
    # Warm-start march: keep a per-pixel t cache across training steps and
    # march warm_steps from backoff * cached_t instead of 40 from 0. t is
    # detached (reference renderer_diff.rs:25) so any converged root of the
    # CURRENT field is semantically equivalent; the cache is prefilled with a
    # full cold march at each stage boundary. Off by default (exact parity).
    warm_start: bool = False
    warm_steps: int = 16
    warm_backoff: float = 0.8
    # Fused shade/composite kernels with hand-written backwards for the
    # gradient path, dense (K2, ops/cuda/shade_kernel.py) or culled (K6,
    # ops/cuda/culled_shade_kernel.py); active when use_pallas is.
    use_fused_shade: bool = True
    # Steps per chunk (the JAX package's steps per device call): the repulsion
    # tables are rebuilt at each chunk start and the loss is read only at
    # chunk ends. Must divide steps_per_stage, else 1. 0 = auto: the largest
    # divisor of steps_per_stage up to 100 (Trainer) or 350
    # (DistributedTrainer), the JAX package's targets.
    steps_per_call: int = 0
    # Steps recorded in one CUDA graph (the JAX package's scan unroll
    # factor); a chunk replays that graph steps_per_call / scan_unroll times.
    scan_unroll: int = 1
    # Coherent-tile culling (ops/culling.py) for large primitive counts:
    # batch indices are sorted (order-free for a with-replacement mean) and
    # every field evaluation runs against per-tile top-K tables. Pair with
    # dataset_order="morton" so sorted indices form compact pixel blocks.
    use_culling: bool = False
    cull_budget: int = 256
    cull_tile: int = 512
    # Two-level selection (ops/culling.build_clusters): cluster bounding
    # spheres cull first, per-primitive top-K only over surviving clusters.
    # Wins once the flat [n_tiles, M] top_k dominates — large M AND many
    # tiles (512px renders); membership refreshes each stage, bounds track
    # live centers every step (always conservative).
    cull_hierarchical: bool = False
    cull_cluster_group: int = 64
    cull_cluster_budget: int = 32
    # Two-level (intra-cluster exact + centroid far-field) repulsion instead
    # of the exact O(M^2) pairwise term — required at M ≳ 20k, where the
    # [M, M] matrix alone dominates the step. Uses the same cluster table
    # as cull_hierarchical.
    cluster_repulsion: bool = False
    # In-run stage guard (extension of the original, default OFF = reference
    # parity): the density-control trajectory is stochastic and ~2/10
    # turbo seeds collapse mid-run with runaway splitting (final N 10-12
    # vs 6-7, 24-30 dB — runs/r3_hw:turbo_seeds). The guard evaluates
    # train-view PSNR before and after each stage's optimization (both
    # under the FINAL render config, so the scale is stage-invariant) and
    # re-runs a stage with a fresh restart key when it fails to improve by
    # stage_guard_min_gain_db (up to stage_guard_retries retries, keeping
    # the best candidate either way). This turns the --best-of N
    # brute-force mitigation into an in-run check that only pays for
    # retries when a stage actually went bad.
    stage_guard: bool = False
    stage_guard_retries: int = 2
    # Stage bar: post-stage PSNR must reach pre-stage + this (slightly
    # negative default tolerates converged final stages that wiggle by
    # hundredths without burning retries).
    stage_guard_min_gain_db: float = -0.1
    # Boundary bar: density control (prune/split/merge) may cost at most
    # this much PSNR vs the accepted post-stage value before the guard
    # re-rolls it with a fresh rng (healthy boundaries measured 0-0.5 dB
    # on the bundled scene; collapse trajectories lose 1.3-2.2 dB at a
    # boundary before the next stage ever runs).
    stage_guard_boundary_db: float = 1.0
    # Views used by the guard evaluator (0 = all training views). The
    # guard compares pre vs post on the SAME subset, so a strided subset
    # only trades detection sensitivity for eval time on many-view rigs.
    stage_guard_views: int = 0
    # Cap on the cull budget used by derivative-free refinement's
    # PROPOSAL-LOSS renders (train/refine.py). The default is the JAX
    # package's (a limit of the TPU worker it was measured on); raise it to
    # cover cull_budget so the acceptance estimator sees the full forward;
    # correctness never depends on it (the caller's full-PSNR gate runs at
    # the full budget), and refine logs whenever the cap engages.
    refine_max_budget: int = 2048
    dataset_order: str = "raster"    # "raster" | "morton"
    # Batch construction: "pixel" = the reference's i.i.d. pixel sampler
    # (dataset.rs:47-82). "tile" = sample whole cull_tile-sized Morton
    # blocks (fg-boosted at tile granularity, batch/cull_tile tiles per
    # step). i.i.d. pixels SORTED across a many-view dataset put rays from
    # several cameras into one cull tile — the tile cone degenerates and
    # top-K selection is arbitrary among all M (the round-1 config-5
    # flatline). Block sampling gives training the same compact single-view
    # tiles rendering uses; requires use_culling + dataset_order="morton".
    sample_mode: str = "pixel"

    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    density: DensityConfig = dataclasses.field(default_factory=DensityConfig)

    # Paths
    data_dir: str = "data"
    cameras_json: str = "data/cameras.json"
    steps_dir: str = "steps"
    scene_json: str = "scene.json"
    checkpoint_dir: Optional[str] = "checkpoints"
    metrics_jsonl: Optional[str] = None  # structured metrics sink (utils/metrics.py)

    @property
    def total_steps(self) -> int:
        return self.stages * self.steps_per_stage

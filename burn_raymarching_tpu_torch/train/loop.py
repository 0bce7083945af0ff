"""Multi-stage training loop (port of burn_raymarching_tpu/train/loop.py).

5 stages x 700 Adam steps, per-stage optimizer rebuild (moment reset),
smooth_k 5→32 and uniform_ratio 0.8→0.4 anneals, LR 0.05·0.6^stage with a
×0.2 mid-stage drop, per-stage preview PNGs, prune/split between stages,
stage checkpoints (the JAX package's .npz keys) with resume, final
scene.json export. The large-scene path (configs 4-5) adds Morton dataset
order, tile-block sampling, culled steps, the warm-start t cache (prefilled
by a full cold march at every stage start) and the two-level cluster
repulsion, whose cluster table is rebuilt once per stage from the
stage-start centers.

A stage runs in chunks of ``self._chunk`` steps (``steps_per_call``,
resolved as the JAX package resolves it: ``_chunk_target`` /
``_resolve_chunk``), through train/chunk.ChunkRunner. At each chunk start
the repulsion's frozen tables (train/loss.RepulsionStatic) are rebuilt
from the live centers, as the JAX package's ``run_chunk`` does; at chunk
ends where the step is a multiple of 100, or the last, the loss is read
back to the host and logged. On a CUDA dataset every step is a replay of
a CUDA graph of ``scan_unroll`` steps, captured once per ``run_stage``
(one stage, one step closure) and freed at its end; the static buffers it
reads are listed in train/chunk.py. On the CPU, and in the sharded
trainer over a gloo mesh, the steps run one at a time. The kernels are
used when ``use_pallas`` is set and the dataset lives on a CUDA device.

Around that loop stands the quality recipe: per-stage render schedules
(coverage family, mask sharpness, supersample factor, pixel-area mask) with
one step closure per distinct override set, ``polish`` (extra last-stage
rounds, kept only when train-view PSNR improves), ``refine_geometry``
(derivative-free rounds of train/refine.py under the same gate), the
stage guard (``_run_guarded``: a stage or a density-control boundary that
costs PSNR is re-rolled) and residual-attribution splitting
(train/residual.py).

Subclass hooks (parallel/distributed.DistributedTrainer overrides them):
``_bucket`` (slot count for n live primitives), ``_place`` / ``_gather``
(the full padded table to this rank's shard and back), ``_init_t_cache``,
``_prepare_stage_params`` (row order at stage start), ``_chunk_target``
(the auto chunk), ``_replays_graphs`` (whether steps replay a captured CUDA
graph), ``_stage_generator``
(the stage's sampling generator), ``_prefill_rays`` (the pixels this rank
prefills), ``_culled_march`` (the detached culled march for a tile batch),
``_march_tile_quantum`` (what a prefill chunk's tile count is padded to a
multiple of), ``_global_dataset`` (the whole dataset, for residual scoring
and refinement), ``_build_cluster_table`` and ``_warm_gate``; ``_io`` gates the
file writes (scene.json, previews, checkpoints, metrics).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.data.dataset import RayDataset
from burn_raymarching_tpu_torch.data.image_io import (
    load_image_as_array,
    save_array_as_image,
)
from burn_raymarching_tpu_torch.data.scene_io import (
    export_scene_json,
    load_cameras,
)
from burn_raymarching_tpu_torch.models.scene import (
    SceneParams,
    activate,
    init_scene_params,
    init_scene_params_cloud,
    pad_params,
    params_from_numpy,
    params_to_numpy,
    unpad_params,
)
from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
    culled_march_normals,
)
from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
    march_shade,
)
from burn_raymarching_tpu_torch.ops.cuda.repulsion_kernel import (
    cluster_repulsion_fused,
)
from burn_raymarching_tpu_torch.ops.culling import (
    PrimitiveClusters,
    build_clusters,
)
from burn_raymarching_tpu_torch.render.preview import CullRender, render_tiled
from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
from burn_raymarching_tpu_torch.train.density import prune_and_split
from burn_raymarching_tpu_torch.train.evaluate import evaluate_views
from burn_raymarching_tpu_torch.train.loss import build_repulsion_static
from burn_raymarching_tpu_torch.train.refine import (
    geometry_refine,
    light_refine,
    sample_fg_tile_batches,
)
from burn_raymarching_tpu_torch.train.residual import (
    primitive_residual_scores,
)
from burn_raymarching_tpu_torch.train.optimizer import (
    anneal_for_step,
    make_optimizer,
)
from burn_raymarching_tpu_torch.train.step_body import (
    culled_march_backend,
    culled_tables,
    lr_scale_tree,
    make_device_step,
)
from burn_raymarching_tpu_torch.utils import (
    MetricsLogger,
    bucket_size,
    multi_view_morton_permutation,
)
from burn_raymarching_tpu_torch.utils.device import resolve_device
from burn_raymarching_tpu_torch.utils.profiling import TRACER, annotate


def build_dataset(cfg: TrainConfig, device: torch.device | str = "cuda"
                  ) -> RayDataset:
    """cameras.json + target images → one flat ray dataset on ``device``
    (the card unless the caller names the CPU).

    dataset_order="morton" stores each view's rays in Z-order so that sorted
    batch indices form compact pixel blocks, the coherence the culled step
    needs; sampling and loss semantics are unchanged."""
    device = resolve_device(device)
    if cfg.dataset_order not in ("raster", "morton"):
        raise ValueError(f"unknown dataset_order {cfg.dataset_order!r}")
    cams = load_cameras(cfg.cameras_json)
    ro_list, rd_list, tgt_list = [], [], []
    for cam in cams:
        # Built on the host: the Morton permutation below is NumPy.
        ro, rd = create_camera_rays(cfg.width, cfg.height, cam["origin"],
                                    cam["target"], cam["fov"], device="cpu")
        ro_list.append(ro.numpy())
        rd_list.append(rd.numpy())
        tgt_list.append(load_image_as_array(cam["file"]))
    ro, rd, tgt = (np.concatenate(x) for x in (ro_list, rd_list, tgt_list))
    if cfg.dataset_order == "morton":
        perm = multi_view_morton_permutation(cfg.width, cfg.height, len(cams))
        ro, rd, tgt = ro[perm], rd[perm], tgt[perm]
    return RayDataset(ro, rd, tgt, fg_threshold=cfg.fg_pixel_threshold,
                      device=device)


def split_key(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic host-side key split: key [2] uint32 → (next, sub)."""
    k = np.random.default_rng([int(x) for x in key]).integers(
        0, 2 ** 32, size=(2, 2), dtype=np.uint32)
    return k[0], k[1]


def fold_key(key: np.ndarray, data: int) -> np.ndarray:
    """Deterministic derived key: (key [2] uint32, int) → key [2] uint32."""
    return np.random.default_rng([int(x) for x in key] + [int(data)]
                                 ).integers(0, 2 ** 32, size=2,
                                            dtype=np.uint32)


def generator_from_key(key: np.ndarray, device: torch.device
                       ) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(key[0]) << 32) | int(key[1]))
    return gen


class Trainer:
    # Whether this process writes files (a sharded trainer sets it on one
    # rank only).
    _io = True

    def __init__(self, cfg: TrainConfig, dataset: RayDataset,
                 log: Callable[[str], None] = print):
        # Fail at construction, not after a trained stage.
        if cfg.density.split_mode == "residual" and not cfg.use_culling:
            raise ValueError('split_mode="residual" requires use_culling '
                             '(it exists for the compact-cloud configs)')
        if (cfg.coverage_mode_stages
                and cfg.coverage_mode_stages[-1] != cfg.render.coverage_mode):
            raise ValueError(
                f"coverage_mode_stages ends with "
                f"{cfg.coverage_mode_stages[-1]!r} but render.coverage_mode "
                f"(used by eval/preview/polish/export) is "
                f"{cfg.render.coverage_mode!r} — they must agree or the "
                f"reported PSNR measures a different forward than the one "
                f"trained")
        if (cfg.mask_sharpness_stages
                and float(cfg.mask_sharpness_stages[-1])
                != cfg.render.mask_sharpness):
            raise ValueError(
                f"mask_sharpness_stages ends with "
                f"{cfg.mask_sharpness_stages[-1]} but render.mask_sharpness "
                f"(used by eval/preview/polish/export) is "
                f"{cfg.render.mask_sharpness} — they must agree")
        if (cfg.supersample_stages
                and int(cfg.supersample_stages[-1]) != cfg.render.supersample):
            raise ValueError(
                f"supersample_stages ends with {cfg.supersample_stages[-1]} "
                f"but render.supersample is {cfg.render.supersample} — the "
                f"schedule must end at the forward the point-sampled "
                f"evaluator measures")
        if (cfg.mask_px_stages
                and float(cfg.mask_px_stages[-1])
                != cfg.render.mask_pixel_mult):
            raise ValueError(
                f"mask_px_stages ends with {cfg.mask_px_stages[-1]} but "
                f"render.mask_pixel_mult is {cfg.render.mask_pixel_mult} — "
                f"they must agree")
        needs_px = (cfg.render.supersample > 1
                    or any(int(v) > 1 for v in cfg.supersample_stages)
                    or any(float(m) > 0 for m in cfg.mask_px_stages))
        if needs_px and cfg.render.pixel_angle <= 0.0:
            raise ValueError(
                "supersample/mask_px stages need render.pixel_angle "
                "(2*tan(fov/2)/height) — without it the pixel footprint "
                "is undefined")
        self.cfg = cfg
        self.dataset = dataset
        self.device = dataset.device
        self.log = log
        self.march_normal_fn = None
        self.culled_march_normal_fn = None
        self.repulsion_fn = None
        if cfg.use_pallas and self.device.type == "cuda":
            # The hand kernels: K1 (dense march + normals), K3 (culled
            # march + normals), K4 (cluster repulsion); K2 is picked by the
            # step body. None = the plain versions.
            self.march_normal_fn = march_shade
            self.culled_march_normal_fn = culled_march_normals
            self.repulsion_fn = cluster_repulsion_fused
        self.warm = self._warm_gate()
        if cfg.sample_mode == "tile":
            if not cfg.use_culling or cfg.dataset_order != "morton":
                raise ValueError('sample_mode="tile" requires use_culling '
                                 'and dataset_order="morton"')
            if cfg.batch_size % cfg.cull_tile:
                raise ValueError("batch_size must divide by cull_tile for "
                                 'sample_mode="tile"')
            self._sample_fg = dataset.tile_fg(cfg.cull_tile)
        else:
            self._sample_fg = (dataset.fg_indices, dataset.num_fg)
        self.lr_scales = lr_scale_tree(cfg)
        self._chunk = self._resolve_chunk()
        self.step_fn = self._build_step()
        # One step closure per distinct per-stage render override set
        # (coverage_mode_stages, mask_sharpness_stages, supersample_stages,
        # mask_px_stages), built at first use.
        self._step_fns: dict = {}
        self.loss_history: list[float] = []
        # Stage-guard telemetry: how often the in-run guard fired.
        self.guard_retry_count = 0
        self.guard_boundary_redo_count = 0
        self._guard_eval = None
        # What the gated rounds, the density boundaries and the guard
        # decided, in order: one dict per event, keyed by "kind" ("polish",
        # "refine", "density", "guard"). Callers read this, not the log.
        self.events: list[dict] = []
        self.metrics = MetricsLogger(cfg.metrics_jsonl if self._io else None)
        self.t_cache = None
        if self.warm:
            self.t_cache = self._init_t_cache()

    def _chunk_target(self) -> int:
        """Auto steps_per_call ceiling: the reference's 100-step log
        cadence, the JAX Trainer's."""
        return 100

    def _resolve_chunk(self) -> int:
        """steps_per_call resolution, the JAX package's: an explicit value
        as given when it divides steps_per_stage, else 1; 0 = the largest
        divisor of steps_per_stage up to ``_chunk_target``."""
        cfg = self.cfg
        if cfg.steps_per_call:
            return (cfg.steps_per_call
                    if cfg.steps_per_stage % cfg.steps_per_call == 0 else 1)
        best = 1
        for d in range(1, min(self._chunk_target(),
                              cfg.steps_per_stage) + 1):
            if cfg.steps_per_stage % d == 0:
                best = d
        return best

    def _replays_graphs(self) -> bool:
        """Whether the steps replay a captured CUDA graph: on a CUDA
        dataset, always."""
        return self.device.type == "cuda"

    def _init_t_cache(self) -> torch.Tensor:
        return torch.zeros((self.dataset.num_total_pixels,),
                           dtype=torch.float32, device=self.device)

    def _bucket(self, n: int) -> int:
        """Padded primitive-slot count for n live primitives. Subclasses add
        layout quanta (even model shards, whole cluster groups)."""
        return bucket_size(n)

    def _place(self, padded: SceneParams, mask: torch.Tensor
               ) -> tuple[SceneParams, torch.Tensor]:
        """The freshly padded table as this process trains it (all of it
        here; a model-sharded trainer keeps its shard's rows)."""
        return padded, mask

    def _gather(self, padded: SceneParams, mask: torch.Tensor
                ) -> tuple[SceneParams, torch.Tensor]:
        """Inverse of ``_place``: the whole padded table after a stage."""
        return padded, mask

    def _prepare_stage_params(self, params: SceneParams) -> SceneParams:
        """Row order at stage start (unchanged here; the sharded trainer
        Morton-sorts the rows so that consecutive cluster groups and the
        model shards are spatially coherent). A scene is a set, so any
        order is semantics-free; run() calls this before snapshotting the
        stage-start centers that density control diffs against."""
        return params

    def _stage_generator(self, key: np.ndarray) -> torch.Generator:
        """The sampling generator of a stage (or polish round) from its
        key."""
        return generator_from_key(key, self.device)

    def _prefill_rays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The rays whose t the cache holds (all of them here)."""
        return self.dataset.rays_o, self.dataset.rays_d

    def _global_dataset(self) -> RayDataset:
        """The whole dataset: residual scoring and refinement read every
        pixel."""
        return self.dataset

    def _culled_march(self, b_t: int) -> Callable:
        """The detached culled march for a batch of ``b_t`` tiles."""
        return culled_march_backend(self.culled_march_normal_fn, b_t)

    def _march_tile_quantum(self) -> int:
        """The tile count of a culled march batch divides by this (the
        union-table march splits the tiles over the model ranks)."""
        return 1

    def _warm_gate(self) -> bool:
        """Warm start needs a march that takes t_init: the culled path
        always has one (K3 or its plain version), the dense path needs K1."""
        if not self.cfg.warm_start:
            return False
        return self.cfg.use_culling or self.march_normal_fn is not None

    def _coverage_for_stage(self, stage: int) -> str:
        sched = self.cfg.coverage_mode_stages
        if not sched:
            return self.cfg.render.coverage_mode
        return sched[min(stage, len(sched) - 1)]

    def _render_overrides_for_stage(self, stage: int) -> dict:
        """Per-stage RenderConfig overrides (coverage family, mask
        sharpness, supersample and pixel-area mask schedules), {} when no
        schedule is set. Each schedule clamps to its last entry."""
        cfg = self.cfg
        out = {}
        if cfg.coverage_mode_stages:
            out["coverage_mode"] = self._coverage_for_stage(stage)
        for name, sched, cast in (
                ("mask_sharpness", cfg.mask_sharpness_stages, float),
                ("supersample", cfg.supersample_stages, int),
                ("mask_pixel_mult", cfg.mask_px_stages, float)):
            if sched:
                out[name] = cast(sched[min(stage, len(sched) - 1)])
        return out

    def _stage_cfg(self, render_overrides: Optional[dict]) -> TrainConfig:
        """cfg with per-stage render fields overridden."""
        if not render_overrides:
            return self.cfg
        return dataclasses.replace(
            self.cfg,
            render=dataclasses.replace(self.cfg.render, **render_overrides))

    def _build_step(self, render_overrides: Optional[dict] = None):
        cfg = self._stage_cfg(render_overrides)
        return make_device_step(
            cfg, march_normal_fn=self.march_normal_fn, batch=cfg.batch_size,
            culled_march_fn=self.culled_march_normal_fn,
            repulsion_fn=self.repulsion_fn, warm=self.warm)

    def _step_for_stage(self, stage: int):
        """The stage's step closure. Without schedules, and for stages whose
        overrides equal the base render config, this is ``self.step_fn``,
        so callers that replace it keep working."""
        base = self.cfg.render
        over = {k: v for k, v in
                self._render_overrides_for_stage(stage).items()
                if getattr(base, k) != v}
        if not over:
            return self.step_fn
        key = tuple(sorted(over.items()))
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(over)
        return self._step_fns[key]

    def _build_cluster_table(self, padded: SceneParams, mask: torch.Tensor
                             ) -> Optional[PrimitiveClusters]:
        """Morton cluster membership for hierarchical culling / cluster
        repulsion from the stage-start centers, or None when neither is
        on."""
        cfg = self.cfg
        if not ((cfg.use_culling and cfg.cull_hierarchical)
                or cfg.cluster_repulsion):
            return None
        return build_clusters(padded.centers.detach().cpu().numpy(),
                              mask=mask.cpu().numpy(),
                              group=cfg.cull_cluster_group,
                              device=self.device)

    def _init_params(self) -> SceneParams:
        cfg = self.cfg
        if cfg.init_layout == "cloud":
            points = None
            if cfg.init_points:
                with open(cfg.init_points) as f:
                    points = np.asarray(json.load(f)["points"],
                                        np.float32).reshape(-1, 3)
            return init_scene_params_cloud(
                cfg.init_n, seed=cfg.seed, extent=cfg.init_cloud_extent,
                radius=cfg.init_cloud_radius,
                ambient_logit=cfg.init_ambient_logit, points=points,
                jitter=cfg.init_points_jitter, device=self.device)
        return init_scene_params(cfg.init_n, cfg.init_offset,
                                 cfg.init_ambient_logit, device=self.device)

    def run_stage(self, params: SceneParams, stage: int,
                  generator: torch.Generator, num_steps: Optional[int] = None,
                  idx_fn: Optional[Callable[[int], torch.Tensor]] = None,
                  step_offset: int = 0
                  ) -> tuple[SceneParams, torch.Tensor, torch.Tensor]:
        """One generation of optimization → (padded params, mask, last loss).

        ``idx_fn(step)`` injects fixed batch indices (tests).
        ``step_offset`` shifts the in-stage step counter: polish() uses it
        to pin the anneals past the schedule end. The steps run in chunks
        of ``self._chunk`` (module docstring); ``steps`` must divide by it
        (ValueError, as in the JAX package), and the chunk by
        ``scan_unroll``.
        """
        cfg = self.cfg
        steps = num_steps if num_steps is not None else cfg.steps_per_stage
        chunk = self._chunk
        if steps % chunk:
            raise ValueError(f"steps ({steps}) must be divisible by "
                             f"steps_per_call ({chunk})")
        if chunk % cfg.scan_unroll:
            raise ValueError(f"steps_per_call ({chunk}) must be divisible "
                             f"by scan_unroll ({cfg.scan_unroll})")
        TRACER.count("stages")
        with annotate("trainer.stage", stage=stage):
            padded, mask = self._place(*pad_params(params,
                                                   self._bucket(params.n)))
            opt = make_optimizer(cfg, padded)
            loss = torch.zeros(())
            n_live = params.n
            if self.warm:
                with annotate("trainer.prefill"):
                    self.prefill_t_cache(
                        padded, mask,
                        anneal_for_step(cfg, stage, 1 + step_offset)[1])
            with annotate("trainer.cluster_tables"):
                clusters = self._build_cluster_table(padded, mask)
            fg_pool, n_fg_pool = self._sample_fg
            runner = ChunkRunner(
                self._step_for_stage(stage), padded, opt,
                lr_scale_tree(cfg, stage), stage, mask, self.dataset.packed,
                fg_pool, n_fg_pool, generator, t_cache=self.t_cache,
                clusters=clusters, idx_fn=idx_fn, step_offset=step_offset,
                unroll=cfg.scan_unroll, graphs=self._replays_graphs())
            t0 = time.perf_counter()
            try:
                for start in range(0, steps, chunk):
                    if cfg.cluster_repulsion:
                        with annotate("trainer.refresh_static"):
                            runner.refresh_static(build_repulsion_static(
                                padded.centers, clusters, mask))
                    runner.run(start + 1, chunk)
                    step = start + chunk
                    if step % 100 == 0 or step == steps:
                        loss = runner.loss.clone()
                        with annotate("trainer.loss_read"):
                            lv = float(loss)   # the only host read of the loop
                        rate = step * cfg.batch_size / (
                            time.perf_counter() - t0)
                        self.loss_history.append(lv)
                        _, smooth_k, _ = anneal_for_step(cfg, stage,
                                                         step + step_offset)
                        self.log(f"  Step {step} | Loss: {lv:.5f} | k: "
                                 f"{smooth_k:.1f} | {rate:,.0f} rays/s")
                        self.metrics.log(stage=stage, step=step, loss=lv,
                                         smooth_k=round(smooth_k, 2),
                                         n_primitives=n_live,
                                         rays_per_s=round(rate))
            finally:
                runner.close()
            return (*self._gather(padded, mask), loss)

    def _load_views(self, cameras=None, targets=None):
        """(cameras, per-view linear targets) of the training views."""
        if cameras is None:
            cameras = load_cameras(self.cfg.cameras_json)
            targets = [load_image_as_array(c["file"]) for c in cameras]
        return cameras, targets

    def views_psnr(self, padded: SceneParams, mask: torch.Tensor,
                   cameras=None, targets=None, chunk: int = 4096,
                   dense: bool = False) -> float:
        """Mean PSNR over ``cameras`` (default: the training views) under
        the FINAL render config, culled like the training step (``dense``
        renders without culling, through K1): what polish, refine, the
        stage guard and best-of compare."""
        cfg = self.cfg
        cameras, targets = self._load_views(cameras, targets)
        rc = cfg.render
        return evaluate_views(
            padded, cameras, targets, cfg.width, cfg.height, mask=mask,
            smooth_k=cfg.max_smooth_k, chunk=chunk,
            march_normal_fn=self.march_normal_fn,
            softmax_sharpness=rc.softmax_sharpness,
            mask_sharpness=rc.mask_sharpness,
            cull=None if dense else self._cull_render(),
            mask_pixel_mult=rc.mask_pixel_mult, pixel_angle=rc.pixel_angle,
            coverage_mode=rc.coverage_mode)["mean"]

    def polish(self, padded: SceneParams, mask: torch.Tensor,
               rounds: int = 2, key: Optional[np.ndarray] = None,
               export: bool = True, cameras: Optional[list] = None,
               targets: Optional[list] = None
               ) -> tuple[SceneParams, torch.Tensor]:
        """Post-final refinement: extra last-stage optimization rounds on
        the final primitive set, no density control, GREEDY by PSNR.

        Each round re-runs ``run_stage`` with the anneals PINNED at their
        final values (smooth_k = max, uniform_ratio = end, post-drop LR, via
        a step offset past the schedule end) and a fresh Adam. A round is
        kept only if it improves mean PSNR on the training views, so polish
        never regresses. Re-exports scene.json and a ``final_polished.png``
        preview when ``export``."""
        cfg = self.cfg
        if key is None:
            key = fold_key(np.asarray([0, cfg.seed], np.uint32), 0x90115)
        cameras, targets = self._load_views(cameras, targets)
        best_psnr = self.views_psnr(padded, mask, cameras, targets)
        self.log(f"Polish baseline: PSNR {best_psnr:.2f}")
        n = int(mask.sum().item())
        for r in range(rounds):
            key, sub = split_key(key)
            cand, cand_mask, _ = self.run_stage(
                self._prepare_stage_params(unpad_params(padded, n)),
                cfg.stages - 1, self._stage_generator(sub),
                step_offset=cfg.steps_per_stage)
            cand_psnr = self.views_psnr(cand, cand_mask, cameras, targets)
            kept = cand_psnr > best_psnr
            self.events.append(dict(kind="polish", round=r + 1,
                                    baseline=float(best_psnr),
                                    psnr=float(cand_psnr), kept=bool(kept)))
            self.log(f"=== Polish round {r + 1}/{rounds}: PSNR "
                     f"{cand_psnr:.2f} ({'kept' if kept else 'reverted'}) "
                     f"===")
            if kept:
                best_psnr, padded, mask = cand_psnr, cand, cand_mask
        if export and self._io:
            export_scene_json(padded, cfg.scene_json,
                              mask=mask.cpu().numpy())
            self.log(f"  => Saved polished scene to {cfg.scene_json} "
                     f"(PSNR {best_psnr:.2f})")
            self.save_preview(padded, mask,
                              os.path.join(cfg.steps_dir,
                                           "final_polished.png"))
        return padded, mask

    def refine_geometry(
        self,
        padded: SceneParams,
        mask: torch.Tensor,
        rounds: int = 1,
        proposals: int = 768,
        phases: int = 3,
        frac: float = 0.05,
        tiles: int = 512,
        proposal_bias: str = "uniform",   # "uniform" | "residual"
        sigma_c: float = 0.3,             # center noise (x primitive radius)
        sigma_r: float = 0.15,            # raw radius noise
        sigma_col: float = 0.0,           # joint color-logit proposals
        accept_temp: float = 0.0,         # Metropolis chain temperature
        fringe_weight: float = 1.0,       # band-weighted acceptance loss
        light_proposals: int = 0,         # global light/ambient micro-search
        key: Optional[np.ndarray] = None,
        chunk: Optional[int] = None,      # proposals per host read
        export: bool = True,
        cameras: Optional[list] = None,
        targets: Optional[list] = None,
    ) -> tuple[SceneParams, torch.Tensor]:
        """Derivative-free geometry refinement, greedily PSNR-gated.

        Runs train/refine.geometry_refine (stochastic hill-climbing on
        centers/radii, and colors when ``sigma_col`` > 0, against two
        disjoint fg-tile ray batches), optionally followed by
        train/refine.light_refine (``light_proposals`` > 0), and keeps a
        round only if mean train-view PSNR improves: the never-regress
        contract of ``polish``. Each round samples fresh acceptance
        batches. Requires the tile-culled configuration."""
        cfg = self.cfg
        if not cfg.use_culling or cfg.dataset_order != "morton":
            raise ValueError(
                "refine_geometry needs use_culling + dataset_order='morton' "
                "(fg-tile acceptance batches + the culled renderer)")
        if proposal_bias not in ("uniform", "residual"):
            raise ValueError(f"unknown proposal_bias {proposal_bias!r}")
        if key is None:
            key = fold_key(np.asarray([0, cfg.seed], np.uint32), 0xEF1E)
        cameras, targets = self._load_views(cameras, targets)
        kern = self.culled_march_normal_fn
        best_psnr = self.views_psnr(padded, mask, cameras, targets)
        self.log(f"Refine baseline: PSNR {best_psnr:.2f}")
        for r in range(rounds):
            key, sub = split_key(key)
            batches = sample_fg_tile_batches(
                self._global_dataset(), tiles=tiles,
                seed=cfg.seed + 7919 * (r + 1), tile=cfg.cull_tile)
            select_probs = None
            if proposal_bias == "residual":
                # Concentrate proposals on the primitives carrying the
                # residual error (recomputed per round: geometry moves).
                select_probs = primitive_residual_scores(
                    padded, mask, self._global_dataset(), cfg,
                    cfg.max_smooth_k, kern=kern)
            cand, stats = geometry_refine(
                padded, mask, batches, cfg, kern=kern, proposals=proposals,
                phases=phases, frac=frac, sigma_c=sigma_c, sigma_r=sigma_r,
                sigma_col=sigma_col, accept_temp=accept_temp,
                fringe_weight=fringe_weight, select_probs=select_probs,
                generator=generator_from_key(sub, self.device), chunk=chunk,
                log=self.log)
            n_acc, n_prop = stats.accepted, stats.proposals
            if light_proposals > 0:
                key, sub = split_key(key)
                cand, lstats = light_refine(
                    cand, mask, batches, cfg, kern=kern,
                    proposals=light_proposals, fringe_weight=fringe_weight,
                    generator=generator_from_key(sub, self.device),
                    log=self.log)
                n_acc += lstats.accepted
                n_prop += lstats.proposals
            cand_psnr = self.views_psnr(cand, mask, cameras, targets)
            kept = cand_psnr > best_psnr
            self.events.append(dict(kind="refine", round=r + 1,
                                    baseline=float(best_psnr),
                                    psnr=float(cand_psnr), accepted=n_acc,
                                    proposals=n_prop, kept=bool(kept)))
            self.log(f"=== Refine round {r + 1}/{rounds}: PSNR "
                     f"{cand_psnr:.2f} ({n_acc}/{n_prop} "
                     f"proposals, {'kept' if kept else 'reverted'}) ===")
            if kept:
                best_psnr, padded = cand_psnr, cand
        if export and self._io:
            export_scene_json(padded, cfg.scene_json,
                              mask=mask.cpu().numpy())
            self.log(f"  => Saved refined scene to {cfg.scene_json} "
                     f"(PSNR {best_psnr:.2f})")
        return padded, mask

    @torch.no_grad()
    def prefill_t_cache(self, padded: SceneParams, mask: torch.Tensor,
                        smooth_k: float) -> None:
        """Full cold march over every dataset pixel → fresh t cache,
        written in place (a captured step reads this buffer); every
        training step then marches only cfg.warm_steps from the cached
        roots."""
        cfg = self.cfg
        rays_o, rays_d = self._prefill_rays()
        centers_p, _, radii_p, _, _ = activate(padded)
        for start in range(0, rays_o.shape[0], cfg.batch_size):
            ro = rays_o[start:start + cfg.batch_size].contiguous()
            rd = rays_d[start:start + cfg.batch_size].contiguous()
            if cfg.use_culling:
                t_flat = self._culled_cold_march(ro, rd, centers_p, radii_p,
                                                 mask, smooth_k)
            else:
                t, _ = self.march_normal_fn(ro, rd, centers_p, radii_p,
                                            smooth_k, mask=mask)
                t_flat = t[:, 0]
            self.t_cache[start:start + ro.shape[0]] = t_flat

    def _culled_cold_march(self, ro, rd, centers_p, radii_p, mask,
                           smooth_k) -> torch.Tensor:
        """Full cold march of one pixel chunk through the culled march (flat
        selection: always conservative). The chunk is padded with copies of
        its last ray to whole tiles, as many as _march_tile_quantum takes."""
        cfg = self.cfg
        n, tile = ro.shape[0], cfg.cull_tile
        pad = -n % (tile * self._march_tile_quantum())
        if pad:
            ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
            rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
        _, _, cs, rs, qs = culled_tables(cfg, ro, rd, centers_p, radii_p,
                                         smooth_k, mask)
        b = ro.shape[0] // tile
        t, _ = self._culled_march(b)(
            ro.reshape(b, tile, 3), rd.reshape(b, tile, 3), cs, rs, qs,
            smooth_k, num_steps=cfg.render.march_steps,
            normal_eps=cfg.render.normal_eps)
        return t.reshape(-1)[:n]

    def _cull_render(self) -> Optional[CullRender]:
        """Culled-render options mirroring the training step's culling
        (flat selection), or None for dense rendering."""
        cfg = self.cfg
        if not cfg.use_culling:
            return None
        return CullRender(tile=cfg.cull_tile, k_budget=cfg.cull_budget,
                          march_normal_fn=self.culled_march_normal_fn)

    def save_preview(self, padded: SceneParams, mask: torch.Tensor,
                     path: str) -> None:
        if not self._io:
            return
        cfg = self.cfg
        with annotate("trainer.preview"):
            ro, rd = create_camera_rays(cfg.width, cfg.height,
                                        [0.0, 0.0, -2.5], [0.0, 0.0, 0.0],
                                        50.0, device=self.device)
            img = render_tiled(
                padded, ro, rd, smooth_k=cfg.max_smooth_k, mask=mask,
                chunk=cfg.preview_chunk, march_normal_fn=self.march_normal_fn,
                softmax_sharpness=cfg.render.softmax_sharpness,
                mask_sharpness=cfg.render.mask_sharpness,
                cull=self._cull_render(), order_wh=(cfg.width, cfg.height),
                mask_pixel_mult=cfg.render.mask_pixel_mult,
                pixel_angle=cfg.render.pixel_angle,
                coverage_mode=cfg.render.coverage_mode)
            save_array_as_image(img, cfg.width, cfg.height, path)
        self.log(f"Saved image to {path}")

    # --- stage guard (config.stage_guard) ------------------------------- #

    def _guard_psnr(self, padded: SceneParams, mask: torch.Tensor) -> float:
        """Mean train-view PSNR under the FINAL render config: the
        stage-invariant health metric the in-run guard compares
        (``stage_guard_views`` > 0 takes an even subsample of the views)."""
        cfg = self.cfg
        if self._guard_eval is None:
            cams = load_cameras(cfg.cameras_json)
            if cfg.stage_guard_views and cfg.stage_guard_views < len(cams):
                stride = max(len(cams) // cfg.stage_guard_views, 1)
                cams = cams[::stride][: cfg.stage_guard_views]
            self._guard_eval = (
                cams, [load_image_as_array(c["file"]) for c in cams])
        cams, tgts = self._guard_eval
        return self.views_psnr(padded, mask, cams, tgts, chunk=16384)

    def _guarded_boundary(self, prev: dict, attempt: int
                          ) -> tuple[SceneParams, float]:
        """Density control with the boundary guard: run prune/split/merge
        from the previous ACCEPTED stage result with an (attempt, redo)-
        salted rng, measure the next generation's PSNR, and re-roll when
        the boundary alone costs more than stage_guard_boundary_db (a bad
        stochastic split draw loses 1-2 dB before the next stage ever runs,
        a healthy boundary 0-0.5 dB). Returns (next params, their PSNR);
        keeps the best roll even if every roll fails the bar."""
        cfg = self.cfg
        stage = prev["stage"]
        best = None
        for redo in range(cfg.stage_guard_retries + 1):
            rng = np.random.default_rng((cfg.seed, stage, attempt, redo))
            cand = self._density_control(
                prev["padded"], prev["mask"], prev["n_live"],
                prev["init_centers"], stage, rng)
            p = self._guard_psnr(*pad_params(cand, bucket_size(cand.n)))
            if best is None or p > best[0]:
                best = (p, cand)
            if p >= prev["psnr"] - cfg.stage_guard_boundary_db:
                break
            self.guard_boundary_redo_count += 1
            self.log(f"  !! stage guard: boundary after stage {stage} cost "
                     f"{prev['psnr'] - p:.2f} dB "
                     f"({prev['psnr']:.2f} -> {p:.2f}) — re-rolling density "
                     f"control ({redo + 1}/{cfg.stage_guard_retries + 1})")
            self.metrics.log(stage=stage, guard_boundary_psnr=round(p, 3),
                             guard_boundary_redo=redo)
        return best[1], best[0]

    def _run_guarded(self, params: SceneParams, key: np.ndarray,
                     start_stage: int) -> tuple[SceneParams, torch.Tensor]:
        """The multi-stage loop with the in-run collapse guard
        (config.stage_guard).

        The density-control trajectory is stochastic and occasionally
        collapses a run (runaway splitting). A failing stage fails
        deterministically under restart-key retries: the damage is in the
        stage's ENTRY params, the preceding stochastic prune/split draw.
        The guard therefore retries the (boundary, stage) pair jointly: a
        stage that fails to improve train-view PSNR by
        stage_guard_min_gain_db is re-run from a FRESH density-control roll
        of the previous accepted result (plus a fresh restart key), and the
        boundary itself re-rolls immediately when it alone costs more than
        stage_guard_boundary_db. Best candidates are kept at both levels,
        so the guard never returns worse than unguarded."""
        cfg = self.cfg
        padded = mask = None
        prev = None                       # accepted previous-stage state
        entry, entry_psnr = params, None  # current stage entry params
        for stage in range(start_stage, cfg.stages):
            self.log(f"=== Stage {stage + 1}/{cfg.stages} "
                     f"(N = {entry.n}) ===")
            key, key_stage = split_key(key)
            best = None
            for attempt in range(cfg.stage_guard_retries + 1):
                if attempt > 0 and prev is not None:
                    entry, entry_psnr = self._guarded_boundary(prev, attempt)
                params_s = self._prepare_stage_params(entry)
                init_centers = params_s.centers.detach().cpu().numpy()
                if entry_psnr is None:
                    entry_psnr = self._guard_psnr(*pad_params(
                        params_s, bucket_size(params_s.n)))
                padded_c, mask_c, _ = self.run_stage(
                    params_s, stage,
                    self._stage_generator(fold_key(key_stage, attempt)))
                psnr_post = self._guard_psnr(padded_c, mask_c)
                self.metrics.log(stage=stage,
                                 guard_psnr_pre=round(entry_psnr, 3),
                                 guard_psnr_post=round(psnr_post, 3),
                                 guard_attempt=attempt)
                self.events.append(dict(kind="guard", stage=stage,
                                        attempt=attempt,
                                        psnr_pre=float(entry_psnr),
                                        psnr_post=float(psnr_post)))
                if best is None or psnr_post > best[0]:
                    best = (psnr_post, padded_c, mask_c, params_s,
                            init_centers)
                if psnr_post >= entry_psnr + cfg.stage_guard_min_gain_db:
                    self.log(f"  stage guard: {entry_psnr:.2f} -> "
                             f"{psnr_post:.2f} dB"
                             + (f" (attempt {attempt} recovered)" if attempt
                                else ""))
                    break
                retryable = attempt < cfg.stage_guard_retries
                if retryable:
                    self.guard_retry_count += 1
                action = ("retrying (fresh boundary + key)" if retryable
                          else "keeping best attempt")
                self.log(f"  !! stage guard: stage {stage} PSNR "
                         f"{psnr_post:.2f} < entry {entry_psnr:.2f} "
                         f"{cfg.stage_guard_min_gain_db:+g} — {action} "
                         f"({attempt + 1}/{cfg.stage_guard_retries + 1})")
            psnr_stage, padded, mask, params_s, init_centers = best
            if stage == cfg.stages - 1:
                self._export_final(padded, mask, params_s.n)
                break
            self.save_preview(
                padded, mask,
                os.path.join(cfg.steps_dir, f"stage_{stage}.png"))
            prev = {"padded": padded, "mask": mask, "n_live": params_s.n,
                    "init_centers": init_centers, "psnr": psnr_stage,
                    "stage": stage}
            entry, entry_psnr = self._guarded_boundary(prev, 0)
            self.save_checkpoint(stage + 1, entry, key)
        return padded, mask

    def _export_final(self, padded: SceneParams, mask: torch.Tensor,
                      n: int) -> None:
        cfg = self.cfg
        self.log("Final Stage Complete! Exporting results...")
        if self._io:
            with annotate("trainer.export"):
                export_scene_json(padded, cfg.scene_json,
                                  mask=mask.cpu().numpy())
        self.log(f"  => Saved to {cfg.scene_json} (N = {n})")
        self.save_preview(padded, mask,
                          os.path.join(cfg.steps_dir, "final_1.png"))

    def _ckpt_path(self, stage: int) -> Optional[str]:
        if not self.cfg.checkpoint_dir:
            return None
        return os.path.join(self.cfg.checkpoint_dir, f"stage_{stage}.npz")

    def save_checkpoint(self, stage: int, params: SceneParams,
                        key: np.ndarray) -> None:
        """Stage-boundary checkpoint of the RAW next-generation params."""
        path = self._ckpt_path(stage)
        if not path or not self._io:
            return
        with annotate("trainer.checkpoint", stage=stage):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez(path, stage=stage, key=np.asarray(key),
                     **params_to_numpy(params))

    def latest_checkpoint(self):
        """(stage, params, key) of the newest stage checkpoint, or None."""
        d = self.cfg.checkpoint_dir
        if not d or not os.path.isdir(d):
            return None
        stages = [int(f[len("stage_"):-len(".npz")]) for f in os.listdir(d)
                  if f.startswith("stage_") and f.endswith(".npz")]
        if not stages:
            return None
        best = max(stages)
        with np.load(self._ckpt_path(best)) as ck:
            return (best, params_from_numpy(ck, device=self.device),
                    np.asarray(ck["key"], np.uint32).reshape(-1)[:2])

    def run(self, resume: bool = False
            ) -> tuple[SceneParams, torch.Tensor]:
        """Full multi-stage run → (final padded params, mask)."""
        cfg = self.cfg
        TRACER.count("jobs")
        with annotate("trainer.run", seed=cfg.seed):
            key = np.asarray([0, cfg.seed], np.uint32)
            rng = np.random.default_rng(cfg.seed)
            with annotate("trainer.init"):
                params = self._init_params()
            start_stage = 0
            if resume:
                ck = self.latest_checkpoint()
                if ck is not None:
                    start_stage, params, key = ck
                    self.log(f"Resuming from stage {start_stage} checkpoint")

            self.log("Start Multi-Stage Optimization...")
            if cfg.stage_guard:
                return self._run_guarded(params, key, start_stage)
            with annotate("trainer.init"):
                padded, mask = pad_params(params, bucket_size(params.n))
            for stage in range(start_stage, cfg.stages):
                self.log(f"=== Stage {stage + 1}/{cfg.stages} "
                         f"(N = {params.n}) ===")
                params = self._prepare_stage_params(params)
                stage_init_centers = params.centers.detach().cpu().numpy()
                key, sub = split_key(key)
                padded, mask, _ = self.run_stage(params, stage,
                                                 self._stage_generator(sub))
                if stage == cfg.stages - 1:
                    self._export_final(padded, mask, params.n)
                    break
                self.save_preview(padded, mask,
                                  os.path.join(cfg.steps_dir,
                                               f"stage_{stage}.png"))
                params = self._density_control(padded, mask, params.n,
                                               stage_init_centers, stage, rng)
                self.save_checkpoint(stage + 1, params, key)
            return padded, mask

    def _density_control(self, padded: SceneParams, mask: torch.Tensor,
                         n_live: int, stage_init_centers: np.ndarray,
                         stage: int, rng: np.random.Generator) -> SceneParams:
        """Generation boundary: prune/split (+ optional merge / residual
        scoring) on the live rows → next generation's params."""
        cfg = self.cfg
        with annotate("trainer.density", stage=stage):
            with annotate("density.read"):
                live = params_to_numpy(unpad_params(padded, n_live))
            split_scores = None
            if cfg.density.split_mode == "residual":
                # Residual attribution through the compositor weights, scored
                # on the padded params (live rows are the first n) under the
                # STAGE's forward, not the final one: residuals must reflect
                # the model the stage trained.
                k_end = anneal_for_step(cfg, stage, cfg.steps_per_stage)[1]
                split_scores = primitive_residual_scores(
                    padded, mask, self._global_dataset(),
                    self._stage_cfg(self._render_overrides_for_stage(stage)),
                    k_end, kern=self.culled_march_normal_fn)[:n_live]
            with annotate("density.host"):
                centers, colors, radii, stats = prune_and_split(
                    live["centers"], live["colors"], live["radii"],
                    stage_init_centers, stage, cfg.stages, rng, cfg.density,
                    split_scores=split_scores)
            with annotate("density.upload"):
                params = params_from_numpy(
                    {"centers": centers, "colors": colors, "radii": radii,
                     "light_dir": live["light_dir"],
                     "ambient": live["ambient"]},
                    device=self.device)
        pruned = stats.pruned_size + stats.pruned_flyaway + stats.pruned_black
        for name, k in (("in", n_live), ("merged", stats.merged),
                        ("pruned", pruned), ("split", stats.split),
                        ("out", params.n)):
            TRACER.count(f"density.{name}", k)
        self.events.append(dict(kind="density", stage=stage, n_before=n_live,
                                n_after=params.n, kept=int(stats.kept),
                                split=int(stats.split),
                                merged=int(stats.merged)))
        self.log(f"  => Pruning & Splitting complete. Next N = {params.n} "
                 f"(kept {stats.kept}, split {stats.split}, pruned "
                 f"{stats.pruned_size}+{stats.pruned_flyaway}+"
                 f"{stats.pruned_black}, merged {stats.merged})")
        return params

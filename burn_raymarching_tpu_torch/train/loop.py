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

The step loop is a plain per-step Python loop: the JAX package's
``steps_per_call`` / ``scan_unroll`` exist only to hide TPU dispatch and
have no meaning here. The JAX package rebuilds the repulsion's frozen
tables (train/loss.RepulsionStatic) once per scan chunk of 100 steps; this
loop rebuilds them every 100 steps, before steps 1, 101, 201 and so on of
each stage. The loss is read back to the host only at the 100-step log
cadence. The kernels are used when ``use_pallas`` is set and the dataset
lives on a CUDA device. Features outside the ported slices raise
``NotImplementedError`` naming their config field.
"""

from __future__ import annotations

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
from burn_raymarching_tpu_torch.render.culled import culled_march_normals_xla
from burn_raymarching_tpu_torch.render.preview import CullRender, render_tiled
from burn_raymarching_tpu_torch.train.density import prune_and_split
from burn_raymarching_tpu_torch.train.loss import build_repulsion_static
from burn_raymarching_tpu_torch.train.optimizer import (
    anneal_for_step,
    make_optimizer,
    set_group_lrs,
)
from burn_raymarching_tpu_torch.train.step_body import (
    culled_tables,
    lr_scale_tree,
    make_device_step,
)
from burn_raymarching_tpu_torch.utils import (
    MetricsLogger,
    bucket_size,
    multi_view_morton_permutation,
)

# Steps between rebuilds of the repulsion's frozen tables (the JAX
# package's default scan chunk).
REP_STATIC_REFRESH = 100


def unported_features(cfg: TrainConfig) -> list[str]:
    """Config fields (and their CLI flags) set to something this port does
    not implement."""
    rc = cfg.render
    checks = [
        (cfg.stage_guard, "stage_guard (--stage-guard)"),
        (rc.supersample > 1, "render.supersample > 1"),
        (rc.mask_pixel_mult > 0.0, "render.mask_pixel_mult (--mask-px)"),
        (bool(cfg.coverage_mode_stages),
         "coverage_mode_stages (--coverage-stages)"),
        (bool(cfg.mask_sharpness_stages),
         "mask_sharpness_stages (--mask-sharp-stages)"),
        (bool(cfg.supersample_stages), "supersample_stages (--ss-stages)"),
        (bool(cfg.mask_px_stages), "mask_px_stages (--mask-px-stages)"),
        (bool(cfg.lr_scale_centers_stages),
         "lr_scale_centers_stages (--lr-centers-stages)"),
        (cfg.density.split_mode != "reference",
         "density.split_mode (--split-mode residual)"),
    ]
    return [name for bad, name in checks if bad]


def build_dataset(cfg: TrainConfig, device: torch.device | str = "cpu"
                  ) -> RayDataset:
    """cameras.json + target images → one flat ray dataset on ``device``.

    dataset_order="morton" stores each view's rays in Z-order so that sorted
    batch indices form compact pixel blocks, the coherence the culled step
    needs; sampling and loss semantics are unchanged."""
    if cfg.dataset_order not in ("raster", "morton"):
        raise ValueError(f"unknown dataset_order {cfg.dataset_order!r}")
    cams = load_cameras(cfg.cameras_json)
    ro_list, rd_list, tgt_list = [], [], []
    for cam in cams:
        ro, rd = create_camera_rays(cfg.width, cfg.height, cam["origin"],
                                    cam["target"], cam["fov"])
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


def generator_from_key(key: np.ndarray, device: torch.device
                       ) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(key[0]) << 32) | int(key[1]))
    return gen


class Trainer:
    def __init__(self, cfg: TrainConfig, dataset: RayDataset,
                 log: Callable[[str], None] = print):
        bad = unported_features(cfg)
        if bad:
            raise NotImplementedError(
                "not ported to burn_raymarching_tpu_torch: " + ", ".join(bad))
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
        self.step_fn = make_device_step(
            cfg, march_normal_fn=self.march_normal_fn, batch=cfg.batch_size,
            culled_march_fn=self.culled_march_normal_fn,
            repulsion_fn=self.repulsion_fn, warm=self.warm)
        self.loss_history: list[float] = []
        self.metrics = MetricsLogger(cfg.metrics_jsonl)
        self.t_cache = None
        if self.warm:
            self.t_cache = torch.zeros((dataset.num_total_pixels,),
                                       dtype=torch.float32,
                                       device=self.device)

    def _warm_gate(self) -> bool:
        """Warm start needs a march that takes t_init: the culled path
        always has one (K3 or its plain version), the dense path needs K1."""
        if not self.cfg.warm_start:
            return False
        return self.cfg.use_culling or self.march_normal_fn is not None

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
                  idx_fn: Optional[Callable[[int], torch.Tensor]] = None
                  ) -> tuple[SceneParams, torch.Tensor, torch.Tensor]:
        """One generation of optimization → (padded params, mask, last loss).

        ``idx_fn(step)`` injects fixed batch indices (tests).
        """
        cfg = self.cfg
        padded, mask = pad_params(params, bucket_size(params.n))
        opt = make_optimizer(cfg, padded)
        ds = self.dataset
        steps = num_steps if num_steps is not None else cfg.steps_per_stage
        loss = torch.zeros(())
        n_live = params.n
        if self.warm:
            self.prefill_t_cache(padded, mask,
                                 anneal_for_step(cfg, stage, 1)[1])
        clusters = self._build_cluster_table(padded, mask)
        rep_static = None
        fg_pool, n_fg_pool = self._sample_fg
        t0 = time.perf_counter()
        for step in range(1, steps + 1):
            idx = idx_fn(step) if idx_fn is not None else None
            if (cfg.cluster_repulsion
                    and (step - 1) % REP_STATIC_REFRESH == 0):
                rep_static = build_repulsion_static(padded.centers, clusters,
                                                    mask)
            loss, lr = self.step_fn(padded, generator, stage, step, mask,
                                     ds.packed, fg_pool, n_fg_pool,
                                     idx=idx, t_cache=self.t_cache,
                                     clusters=clusters, rep_static=rep_static)
            set_group_lrs(opt, lr, self.lr_scales)
            opt.step()
            if step % 100 == 0 or step == steps:
                lv = float(loss)   # the only host read of the loop
                rate = step * cfg.batch_size / (time.perf_counter() - t0)
                self.loss_history.append(lv)
                _, smooth_k, _ = anneal_for_step(cfg, stage, step)
                self.log(f"  Step {step} | Loss: {lv:.5f} | k: {smooth_k:.1f}"
                         f" | {rate:,.0f} rays/s")
                self.metrics.log(stage=stage, step=step, loss=lv,
                                 smooth_k=round(smooth_k, 2),
                                 n_primitives=n_live, rays_per_s=round(rate))
        return padded, mask, loss

    @torch.no_grad()
    def prefill_t_cache(self, padded: SceneParams, mask: torch.Tensor,
                        smooth_k: float) -> None:
        """Full cold march over every dataset pixel → fresh t cache; every
        training step then marches only cfg.warm_steps from the cached
        roots."""
        cfg = self.cfg
        ds = self.dataset
        centers_p, _, radii_p, _, _ = activate(padded)
        for start in range(0, ds.num_total_pixels, cfg.batch_size):
            ro = ds.rays_o[start:start + cfg.batch_size].contiguous()
            rd = ds.rays_d[start:start + cfg.batch_size].contiguous()
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
        selection: always conservative). The chunk is padded to whole tiles
        with copies of its last ray."""
        cfg = self.cfg
        n, tile = ro.shape[0], cfg.cull_tile
        pad = -n % tile
        if pad:
            ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
            rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
        _, _, cs, rs, qs = culled_tables(cfg, ro, rd, centers_p, radii_p,
                                         smooth_k, mask)
        b = ro.shape[0] // tile
        kern = self.culled_march_normal_fn or culled_march_normals_xla
        t, _ = kern(ro.reshape(b, tile, 3), rd.reshape(b, tile, 3), cs, rs,
                    qs, smooth_k, num_steps=cfg.render.march_steps,
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
        cfg = self.cfg
        ro, rd = create_camera_rays(cfg.width, cfg.height, [0.0, 0.0, -2.5],
                                    [0.0, 0.0, 0.0], 50.0,
                                    device=self.device)
        img = render_tiled(padded, ro, rd, smooth_k=cfg.max_smooth_k,
                           mask=mask, chunk=cfg.preview_chunk,
                           march_normal_fn=self.march_normal_fn,
                           softmax_sharpness=cfg.render.softmax_sharpness,
                           mask_sharpness=cfg.render.mask_sharpness,
                           cull=self._cull_render(),
                           order_wh=(cfg.width, cfg.height),
                           coverage_mode=cfg.render.coverage_mode)
        save_array_as_image(img, cfg.width, cfg.height, path)
        self.log(f"Saved image to {path}")

    def _ckpt_path(self, stage: int) -> Optional[str]:
        if not self.cfg.checkpoint_dir:
            return None
        return os.path.join(self.cfg.checkpoint_dir, f"stage_{stage}.npz")

    def save_checkpoint(self, stage: int, params: SceneParams,
                        key: np.ndarray) -> None:
        """Stage-boundary checkpoint of the RAW next-generation params."""
        path = self._ckpt_path(stage)
        if not path:
            return
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
        key = np.asarray([0, cfg.seed], np.uint32)
        rng = np.random.default_rng(cfg.seed)
        params = self._init_params()
        start_stage = 0
        if resume:
            ck = self.latest_checkpoint()
            if ck is not None:
                start_stage, params, key = ck
                self.log(f"Resuming from stage {start_stage} checkpoint")

        self.log("Start Multi-Stage Optimization...")
        padded, mask = pad_params(params, bucket_size(params.n))
        for stage in range(start_stage, cfg.stages):
            self.log(f"=== Stage {stage + 1}/{cfg.stages} (N = {params.n}) "
                     "===")
            stage_init_centers = params.centers.detach().cpu().numpy()
            key, sub = split_key(key)
            padded, mask, _ = self.run_stage(
                params, stage, generator_from_key(sub, self.device))
            if stage == cfg.stages - 1:
                self.log("Final Stage Complete! Exporting results...")
                export_scene_json(padded, cfg.scene_json,
                                  mask=mask.cpu().numpy())
                self.log(f"  => Saved to {cfg.scene_json} (N = {params.n})")
                self.save_preview(padded, mask,
                                  os.path.join(cfg.steps_dir, "final_1.png"))
                break
            self.save_preview(padded, mask,
                              os.path.join(cfg.steps_dir,
                                           f"stage_{stage}.png"))
            params = self._density_control(padded, params.n,
                                           stage_init_centers, stage, rng)
            self.save_checkpoint(stage + 1, params, key)
        return padded, mask

    def _density_control(self, padded: SceneParams, n_live: int,
                         stage_init_centers: np.ndarray, stage: int,
                         rng: np.random.Generator) -> SceneParams:
        """Generation boundary: prune/split on the live rows → next
        generation's params."""
        cfg = self.cfg
        live = params_to_numpy(unpad_params(padded, n_live))
        centers, colors, radii, stats = prune_and_split(
            live["centers"], live["colors"], live["radii"],
            stage_init_centers, stage, cfg.stages, rng, cfg.density)
        params = params_from_numpy(
            {"centers": centers, "colors": colors, "radii": radii,
             "light_dir": live["light_dir"], "ambient": live["ambient"]},
            device=self.device)
        self.log(f"  => Pruning & Splitting complete. Next N = {params.n} "
                 f"(kept {stats.kept}, split {stats.split}, pruned "
                 f"{stats.pruned_size}+{stats.pruned_flyaway}+"
                 f"{stats.pruned_black}, merged {stats.merged})")
        return params

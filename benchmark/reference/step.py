"""The training step of the reference: a frozen copy of the program's
plain step (train/step_body.py: ``device_schedule``, ``lr_scale_tree``,
``sample_step_indices``, ``culled_tables`` and the single-device branches of
``make_device_step``) with the plain march, renderer and loss, and the
plain Adam of ``adam.py`` in place of ``torch.optim``.

No supersampling, no model or data axis: the benchmark's configurations use
neither, and ``check_config`` refuses one that does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import TrainConfig
from .culled import culled_march_normals_xla, render_diff_culled
from .culling import select_tile_primitives, tile_cones
from .dataset import gather_batch, sample_batch_indices
from .loss import compute_loss
from .scene import SceneParams, activate, scene_forward


def check_config(cfg: TrainConfig) -> None:
    """Refuse what this copy does not carry."""
    if cfg.render.supersample != 1 or cfg.supersample_stages:
        raise ValueError("the reference step has no supersampling")
    if cfg.use_culling and cfg.cull_hierarchical:
        raise ValueError("the reference step has flat selection only")


def lr_scale_tree(cfg: TrainConfig, stage: Optional[int] = None
                  ) -> dict[str, float]:
    centers = cfg.lr_scale_centers
    if stage is not None and cfg.lr_scale_centers_stages:
        sched = cfg.lr_scale_centers_stages
        centers = float(np.float32(sched[min(stage, len(sched) - 1)]))
    return {"centers": centers, "colors": cfg.lr_scale_colors,
            "radii": cfg.lr_scale_radii, "light_dir": cfg.lr_scale_light,
            "ambient": cfg.lr_scale_light}


def device_schedule(cfg: TrainConfig, stage: int, step: torch.Tensor):
    """(progress, smooth_k, uniform_ratio, lr) float32 tensors of a
    1-based step of ``stage``."""
    f32, f64 = np.float32, np.float64
    gs = (step + stage * cfg.steps_per_stage).to(torch.float32)
    progress = torch.clamp(gs * float(f32(1.0) / f32(cfg.total_steps)),
                           max=1.0)
    p64 = progress.to(torch.float64)
    smooth_k = (p64 * float(f32(cfg.max_smooth_k - cfg.min_smooth_k))
                + float(f32(cfg.min_smooth_k))).to(torch.float32)
    uniform_ratio = (float(f32(cfg.uniform_ratio_start))
                     - p64 * float(f32(cfg.uniform_ratio_start
                                       - cfg.uniform_ratio_end))
                     ).to(torch.float32)
    decay = f32(f64(f32(cfg.lr_stage_decay)) ** stage)
    base_lr = f32(cfg.base_lr) * decay
    late_lr = (f32(cfg.base_lr) * f32(cfg.lr_midstage_factor)) * decay
    lr = torch.where(step > cfg.steps_per_stage // 2, float(late_lr),
                     float(base_lr))
    return progress, smooth_k, uniform_ratio, lr


def sample_step_indices(cfg: TrainConfig, generator: torch.Generator,
                        n_pixels: int, fg_indices: torch.Tensor, n_fg: int,
                        batch: int, uniform_ratio) -> torch.Tensor:
    if cfg.sample_mode != "tile":
        return sample_batch_indices(generator, n_pixels, fg_indices, n_fg,
                                    batch, uniform_ratio)
    tile = cfg.cull_tile
    tid = sample_batch_indices(generator, n_pixels // tile, fg_indices, n_fg,
                               batch // tile, uniform_ratio)
    return (tid[:, None] * tile + torch.arange(
        tile, device=tid.device)[None, :]).reshape(-1)


def culled_tables(cfg: TrainConfig, ro, rd, centers, radii, smooth_k, mask):
    """Flat per-tile selection → (idx, valid, cs, rs, qs)."""
    cones = tile_cones(ro, rd, cfg.cull_tile)
    idx, valid = select_tile_primitives(cones, centers, radii, smooth_k,
                                        cfg.cull_budget, mask=mask)
    cs = centers[idx]
    rs = radii.reshape(-1)[idx]
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    return idx, valid, cs, rs, qs


@torch.no_grad()
def cold_march_tiles(cfg: TrainConfig, ro, rd, params: SceneParams, mask,
                     smooth_k) -> torch.Tensor:
    """The cold culled march of whole tiles of rays ([n, 3], n a multiple of
    the tile) on ``params``: the t that the program's stage-start prefill
    writes into its cache for these pixels → [n]."""
    c, _, r, _, _ = activate(params)
    _, _, cs, rs, qs = culled_tables(cfg, ro, rd, c, r, smooth_k, mask)
    b = ro.shape[0] // cfg.cull_tile
    t, _ = culled_march_normals_xla(
        ro.reshape(b, cfg.cull_tile, 3), rd.reshape(b, cfg.cull_tile, 3),
        cs, rs, qs, smooth_k, num_steps=cfg.render.march_steps,
        normal_eps=cfg.render.normal_eps)
    return t.reshape(-1)


def draw_indices(cfg: TrainConfig, generator: torch.Generator, stage: int,
                 step: int, n_pixels: int, fg_indices, n_fg: int
                 ) -> torch.Tensor:
    """The batch indices the step draws from ``generator``, before the
    culled path sorts them."""
    step_t = torch.tensor(step, device=fg_indices.device)
    _, _, uniform_ratio, _ = device_schedule(cfg, stage, step_t)
    return sample_step_indices(cfg, generator, n_pixels, fg_indices, n_fg,
                               cfg.batch_size, uniform_ratio)


def step_loss(cfg: TrainConfig, params: SceneParams, stage: int, step: int,
              mask, packed, idx, t_cache=None, clusters=None,
              rep_static=None, keep=None):
    """One step's forward and loss on the batch ``idx`` (unsorted, as
    drawn) → (loss, lr tensor); with the warm start the march starts from
    the cache and writes its roots back. ``keep`` (a slice) computes the
    loss over part of the batch only, the planted fault of the checks."""
    rc = cfg.render
    dev = packed.device
    step_t = torch.tensor(step, device=dev)
    progress, smooth_k, _, lr = device_schedule(cfg, stage, step_t)
    warm = cfg.warm_start
    if cfg.use_culling:
        idx = torch.sort(idx).values
    ro, rd, tgt = gather_batch(packed, idx)
    culled_pre = None
    if cfg.use_culling:
        with torch.no_grad():
            c_det, _, r_det, _, _ = activate(params)
            t0 = t_cache[idx][:, None] * cfg.warm_backoff if warm else None
            idx_t, valid_t, cs, rs, qs = culled_tables(
                cfg, ro, rd, c_det, r_det, smooth_k, mask)
            b_t = ro.shape[0] // cfg.cull_tile
            t, normal = culled_march_normals_xla(
                ro.reshape(b_t, cfg.cull_tile, 3),
                rd.reshape(b_t, cfg.cull_tile, 3), cs, rs, qs, smooth_k,
                num_steps=cfg.warm_steps if warm else rc.march_steps,
                normal_eps=rc.normal_eps,
                t_init=None if t0 is None else t0.reshape(
                    b_t, cfg.cull_tile, 1))
            culled_pre = (idx_t, valid_t, t, normal)
            if warm:
                t_cache[idx] = t.reshape(-1)
        c_p, col_p, r_p, ld_p, amb_p = activate(params)
        out = render_diff_culled(
            ro, rd, c_p, col_p, r_p, ld_p, amb_p, smooth_k, mask=mask,
            tile=cfg.cull_tile, k_budget=cfg.cull_budget,
            num_steps=rc.march_steps, softmax_sharpness=rc.softmax_sharpness,
            mask_sharpness=rc.mask_sharpness, normal_eps=rc.normal_eps,
            precomputed=culled_pre, mask_pixel_mult=rc.mask_pixel_mult,
            pixel_angle=rc.pixel_angle, coverage_mode=rc.coverage_mode)
    else:
        if warm:
            raise ValueError("the reference's dense step marches cold")
        out = scene_forward(params, ro, rd, smooth_k, mask=mask,
                            num_steps=rc.march_steps,
                            softmax_sharpness=rc.softmax_sharpness,
                            mask_sharpness=rc.mask_sharpness,
                            normal_eps=rc.normal_eps,
                            mask_pixel_mult=rc.mask_pixel_mult,
                            pixel_angle=rc.pixel_angle,
                            coverage_mode=rc.coverage_mode)
    if keep is not None:
        out, tgt = out[keep], tgt[keep]
    loss = compute_loss(
        params, out, tgt, progress, mask=mask, cfg=cfg.loss,
        repulsion_clusters=clusters if cfg.cluster_repulsion else None,
        repulsion_static=rep_static)
    return loss, lr

"""The per-step training computation (port of
burn_raymarching_tpu/train/step_body.py, single-device branches).

One step: sample a batch → forward → loss → autograd. Three forwards:

* culled (``use_culling``): the batch indices are sorted so rays are
  tile-coherent; selection and the K3 march (cold, or warm from the per-
  pixel t cache) run detached outside autograd, and render_diff_culled runs
  only the gradient-carrying tail on tables re-gathered from the live
  parameters;
* dense with the hand kernels (``march_normal_fn`` given): the detached K1
  march (cold, or warm from the t cache) followed by the K2 fused shade,
  or by the plain tail when the render config is not the reference's;
* plain ``scene_forward`` otherwise.

The anneal schedule is computed on the host in float32, as the JAX package
computes it in-graph, so no step reads anything back from the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.data.dataset import (
    gather_batch,
    sample_batch_indices,
)
from burn_raymarching_tpu_torch.models.scene import (
    SceneParams,
    activate,
    scene_forward,
)
from burn_raymarching_tpu_torch.ops.cuda.shade_kernel import shade_fused
from burn_raymarching_tpu_torch.ops.culling import (
    select_tile_primitives,
    select_tile_primitives_hier,
    tile_cones,
)
from burn_raymarching_tpu_torch.render.culled import (
    culled_march_normals_xla,
    render_diff_culled,
)
from burn_raymarching_tpu_torch.train.loss import compute_loss


def lr_scale_tree(cfg: TrainConfig) -> dict[str, float]:
    """Per-parameter-group LR multipliers, keyed like SceneParams."""
    if cfg.lr_scale_centers_stages:
        raise NotImplementedError(
            "TrainConfig.lr_scale_centers_stages (--lr-centers-stages) is "
            "not ported")
    return {"centers": cfg.lr_scale_centers, "colors": cfg.lr_scale_colors,
            "radii": cfg.lr_scale_radii, "light_dir": cfg.lr_scale_light,
            "ambient": cfg.lr_scale_light}


def schedule_for_step(cfg: TrainConfig, stage: int, step: int
                      ) -> tuple[float, float, float, float]:
    """Anneals for a 1-based step: (progress, smooth_k, uniform_ratio, lr),
    computed in float32 like the JAX package's in-graph schedule. progress
    caps at 1."""
    f32 = np.float32
    global_step = f32(stage * cfg.steps_per_stage + step)
    progress = min(global_step / f32(cfg.total_steps), f32(1.0))
    smooth_k = f32(cfg.min_smooth_k) + f32(
        cfg.max_smooth_k - cfg.min_smooth_k) * progress
    uniform_ratio = f32(cfg.uniform_ratio_start) - f32(
        cfg.uniform_ratio_start - cfg.uniform_ratio_end) * progress
    base_lr = f32(cfg.base_lr) * np.power(f32(cfg.lr_stage_decay), f32(stage))
    lr = (base_lr * f32(cfg.lr_midstage_factor)
          if step > cfg.steps_per_stage // 2 else base_lr)
    return float(progress), float(smooth_k), float(uniform_ratio), float(lr)


def uses_fused_shade(cfg: TrainConfig, march_normal_fn) -> bool:
    """The K2 kernel hard-codes the reference compositor and dense tables:
    culled runs and other render configs take the plain tail."""
    rc = cfg.render
    return (march_normal_fn is not None and cfg.use_fused_shade
            and not cfg.use_culling
            and rc.mask_pixel_mult == 0.0 and rc.coverage_mode == "sigmoid"
            and (rc.softmax_sharpness, rc.mask_sharpness) == (10.0, 15.0))


def sample_step_indices(cfg: TrainConfig, generator: torch.Generator,
                        n_pixels: int, fg_indices: torch.Tensor, n_fg: int,
                        batch: int, uniform_ratio: float) -> torch.Tensor:
    """Batch pixel indices: i.i.d. pixels, or with ``sample_mode="tile"``
    whole ``cull_tile`` Morton blocks (fg_indices/n_fg at tile
    granularity, from RayDataset.tile_fg)."""
    if cfg.sample_mode != "tile":
        return sample_batch_indices(generator, n_pixels, fg_indices, n_fg,
                                    batch, uniform_ratio)
    tile = cfg.cull_tile
    if batch % tile:
        raise ValueError(f"batch ({batch}) must divide by cull_tile ({tile})")
    tid = sample_batch_indices(generator, n_pixels // tile, fg_indices, n_fg,
                               batch // tile, uniform_ratio)
    return (tid[:, None] * tile + torch.arange(
        tile, device=tid.device)[None, :]).reshape(-1)


def culled_tables(cfg: TrainConfig, ro: torch.Tensor, rd: torch.Tensor,
                  centers: torch.Tensor, radii: torch.Tensor, smooth_k,
                  mask: Optional[torch.Tensor], clusters=None):
    """Detached per-tile selection → (idx [B,K], valid [B,K], cs [B,K,3],
    rs [B,K], qs [B,K] with 1e30 in invalid slots)."""
    cones = tile_cones(ro, rd, cfg.cull_tile)
    if clusters is not None:
        idx, valid = select_tile_primitives_hier(
            cones, centers, radii, smooth_k, cfg.cull_budget, clusters,
            cfg.cull_cluster_budget, mask=mask)
    else:
        idx, valid = select_tile_primitives(cones, centers, radii, smooth_k,
                                            cfg.cull_budget, mask=mask)
    cs = centers[idx]
    rs = radii.reshape(-1)[idx]
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    return idx, valid, cs, rs, qs


def make_device_step(cfg: TrainConfig, *, march_normal_fn: Optional[Callable],
                     batch: int, culled_march_fn: Optional[Callable] = None,
                     repulsion_fn: Optional[Callable] = None,
                     warm: bool = False) -> Callable:
    """Build device_step(params, generator, stage, step, mask, packed,
    fg_indices, n_fg, idx=None, t_cache=None, clusters=None,
    rep_static=None) → (loss tensor, lr).

    ``step`` is 1-based within the stage. The step leaves the gradients in
    ``params``' ``.grad``. ``idx`` injects the sampled batch indices
    (tests); culled steps sort them. With ``warm`` the march starts from
    ``warm_backoff`` × the cached t of each pixel and writes its result
    back into ``t_cache`` [P] in place. ``clusters`` (PrimitiveClusters)
    feeds hierarchical culling and the cluster repulsion; ``rep_static`` is
    the repulsion's frozen prep. ``culled_march_fn`` (K3) and
    ``repulsion_fn`` (K4) are the kernel wrappers; None takes the plain
    versions.
    """
    rc = cfg.render
    fused = uses_fused_shade(cfg, march_normal_fn)
    tile_march = culled_march_fn or culled_march_normals_xla
    hier = cfg.use_culling and cfg.cull_hierarchical

    def device_step(params: SceneParams, generator: torch.Generator,
                    stage: int, step: int, mask: torch.Tensor,
                    packed: torch.Tensor, fg_indices: torch.Tensor, n_fg: int,
                    idx: Optional[torch.Tensor] = None,
                    t_cache: Optional[torch.Tensor] = None, clusters=None,
                    rep_static=None):
        progress, smooth_k, uniform_ratio, lr = schedule_for_step(
            cfg, stage, step)
        if idx is None:
            idx = sample_step_indices(cfg, generator, packed.shape[0],
                                      fg_indices, n_fg, batch, uniform_ratio)
        if cfg.use_culling:
            # Sorted indices → tile-coherent rays; a with-replacement sample
            # is order-free, so the loss is unchanged.
            idx = torch.sort(idx).values
        ro, rd, tgt = gather_batch(packed, idx)

        culled_pre = None
        t = normal = None
        if cfg.use_culling or fused or (warm and march_normal_fn is not None):
            with torch.no_grad():
                c_det, _, r_det, _, _ = activate(params)
                t0 = None
                if warm:
                    t0 = t_cache[idx][:, None] * cfg.warm_backoff
                if cfg.use_culling:
                    idx_t, valid_t, cs, rs, qs = culled_tables(
                        cfg, ro, rd, c_det, r_det, smooth_k, mask,
                        clusters if hier else None)
                    b_t = ro.shape[0] // cfg.cull_tile
                    t, normal = tile_march(
                        ro.reshape(b_t, cfg.cull_tile, 3),
                        rd.reshape(b_t, cfg.cull_tile, 3), cs, rs, qs,
                        smooth_k,
                        num_steps=cfg.warm_steps if warm else rc.march_steps,
                        normal_eps=rc.normal_eps,
                        t_init=(None if t0 is None else
                                t0.reshape(b_t, cfg.cull_tile, 1)))
                    culled_pre = (idx_t, valid_t, t, normal)
                else:
                    warm_kw = (dict(num_steps=cfg.warm_steps, t_init=t0)
                               if warm else {})
                    t, normal = march_normal_fn(ro, rd, c_det, r_det,
                                                smooth_k, mask=mask,
                                                **warm_kw)
                if warm:
                    t_cache[idx] = t.reshape(-1)

        c_p, col_p, r_p, ld_p, amb_p = activate(params)
        if culled_pre is not None:
            out = render_diff_culled(
                ro, rd, c_p, col_p, r_p, ld_p, amb_p, smooth_k, mask=mask,
                tile=cfg.cull_tile, k_budget=cfg.cull_budget,
                num_steps=rc.march_steps,
                softmax_sharpness=rc.softmax_sharpness,
                mask_sharpness=rc.mask_sharpness, normal_eps=rc.normal_eps,
                precomputed=culled_pre, mask_pixel_mult=rc.mask_pixel_mult,
                pixel_angle=rc.pixel_angle, coverage_mode=rc.coverage_mode)
        elif fused:
            out = shade_fused(ro, rd, t, normal, c_p, r_p, col_p, ld_p,
                              amb_p, smooth_k, mask=mask)
        else:
            mn_fn = march_normal_fn
            if t is not None:
                t_det, n_det = t, normal
                mn_fn = lambda *a, **kw: (t_det, n_det)  # noqa: E731
            out = scene_forward(params, ro, rd, smooth_k, mask=mask,
                                march_normal_fn=mn_fn,
                                num_steps=rc.march_steps,
                                softmax_sharpness=rc.softmax_sharpness,
                                mask_sharpness=rc.mask_sharpness,
                                normal_eps=rc.normal_eps,
                                mask_pixel_mult=rc.mask_pixel_mult,
                                pixel_angle=rc.pixel_angle,
                                coverage_mode=rc.coverage_mode)
        loss = compute_loss(
            params, out, tgt, progress, mask=mask, cfg=cfg.loss,
            repulsion_clusters=clusters if cfg.cluster_repulsion else None,
            repulsion_fn=repulsion_fn, repulsion_static=rep_static)
        params.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach(), lr

    return device_step

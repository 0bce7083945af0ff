"""The per-step training computation (port of
burn_raymarching_tpu/train/step_body.py).

One step: sample a batch → forward → loss → autograd. Three forwards:

* culled (``use_culling``): the batch indices are sorted so rays are
  tile-coherent; selection and the K3 march (cold, or warm from the per-
  pixel t cache) run detached outside autograd, and only the
  gradient-carrying tail runs on tables re-gathered from the live
  parameters: the K6 fused tail (ops/cuda/culled_shade_kernel.py) when
  ``uses_fused_culled_shade``, render_diff_culled otherwise;
* dense with the hand kernels (``march_normal_fn`` given): the detached K1
  march (cold, or warm from the t cache) followed by the K2 fused shade,
  or by the plain tail when the render config is not the reference's;
* plain ``scene_forward`` otherwise.

The anneal schedule is computed on the device from a step-index tensor
(``device_schedule``), as the JAX package computes it in-graph: smooth_k
reaches the kernels, progress the loss, uniform_ratio the sampler and the
learning rate Adam as float32 tensors, so no step reads anything back from
the device and a step recorded once in a CUDA graph replays at any step
index (train/chunk.py).

The axes (parallel/DistributedTrainer) are the only difference between the
single-device and the sharded step:

* ``data_axis`` — every rank samples its batch from its own pixel shard
  (with the t cache of that shard; its generator is folded with the data
  index where it is made), and the gradients and the loss are averaged
  over the axis after the backward, in one all-reduce;
* ``model_axis`` — the primitive rows are sharded: selection is
  shard-local (each rank's per-tile top-K over its own rows), the soft-min
  and softmax combine shards (render/, ops/sdf.py), the cluster table is
  in the shard's own row ids, the loss is the sharded plain version, and
  the detached culled march runs K3 on the union table
  (``sharded_culled_kernel_march``); a tile batch that does not split
  evenly over the axis is an error, never a silent switch to the plain
  march. K2 and K4 see whole tables and are not used under it; K1 has no
  union form, so a model-sharded dense step given K1 is an error too.
  Every rank back-propagates its own copy of the replicated loss; the
  collectives carry shard_map's transposes, so the gradient of a replicated
  leaf (light, ambient) is already the total on every rank.
"""

from __future__ import annotations

import functools
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
from burn_raymarching_tpu_torch.ops.cuda.culled_shade_kernel import (
    culled_shade,
)
from burn_raymarching_tpu_torch.ops.cuda.shade_kernel import shade_fused
from burn_raymarching_tpu_torch.ops.cuda.tile_select_kernel import tile_select
from burn_raymarching_tpu_torch.ops.culling import (
    gather_tile_tables,
    select_tile_primitives_hier,
    selected_tables,
    tile_cones,
)
from burn_raymarching_tpu_torch.parallel.collectives import (
    Axis,
    all_gather,
    all_to_all,
    mean_grads,
)
from burn_raymarching_tpu_torch.render.culled import (
    culled_march_normals_xla,
    render_diff_culled,
)
from burn_raymarching_tpu_torch.train.loss import compute_loss
from burn_raymarching_tpu_torch.utils.profiling import TRACER, annotate


def lr_scale_tree(cfg: TrainConfig, stage: Optional[int] = None
                  ) -> dict[str, float]:
    """Per-parameter-group LR multipliers, keyed like SceneParams.

    With ``stage`` and a non-empty cfg.lr_scale_centers_stages the centers
    multiplier is the stage's entry, clamped to the last one, so polish's
    past-the-end stage keeps the final value."""
    centers = cfg.lr_scale_centers
    if stage is not None and cfg.lr_scale_centers_stages:
        sched = cfg.lr_scale_centers_stages
        centers = float(np.float32(sched[min(stage, len(sched) - 1)]))
    return {"centers": centers, "colors": cfg.lr_scale_colors,
            "radii": cfg.lr_scale_radii, "light_dir": cfg.lr_scale_light,
            "ambient": cfg.lr_scale_light}


def schedule_for_step(cfg: TrainConfig, stage: int, step: int
                      ) -> tuple[float, float, float, float]:
    """Anneals for a 1-based step as host floats: (progress, smooth_k,
    uniform_ratio, lr) of ``device_schedule``. progress caps at 1."""
    return tuple(float(x) for x in device_schedule(cfg, stage,
                                                   torch.tensor(step)))


def device_schedule(cfg: TrainConfig, stage: int, step: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """``schedule_for_step`` with the 1-based step as an integer tensor →
    float32 tensors (progress, smooth_k, uniform_ratio, lr) on its device,
    bitwise the values of the JAX package's schedule as XLA compiles it
    inside its step: progress = global step × f32(1 / total_steps), capped
    at 1; smooth_k and uniform_ratio as fused multiply-adds, one rounding
    (here in float64, where the product of two float32 values is exact);
    the mid-stage rate as (base_lr × factor) × decay^stage. ``stage`` is a
    host int: a captured step closure belongs to one stage."""
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


def subpixel_offsets(ss: int) -> np.ndarray:
    """[ss, 2] fixed sub-pixel sample offsets in [-0.5, 0.5) pixel units:
    a cell-centered regular grid for perfect squares, a golden-ratio
    lattice otherwise. Deterministic, so the supersampled forward is a
    fixed quadrature of the pixel footprint rather than per-step noise."""
    g = int(round(ss ** 0.5))
    if g * g == ss:
        xs = (np.arange(g) + 0.5) / g - 0.5
        u, v = np.meshgrid(xs, xs)
        return np.stack([u.reshape(-1), v.reshape(-1)], axis=1)
    i = np.arange(ss, dtype=np.float64) + 0.5
    return np.stack([i / ss - 0.5, (i * 0.6180339887498949) % 1.0 - 0.5],
                    axis=1)


@functools.cache
def _subpixel_offsets_on(ss: int, pixel_angle: float, dtype: torch.dtype,
                         device: torch.device) -> torch.Tensor:
    """``subpixel_offsets(ss) * pixel_angle`` [ss, 2] on ``device``, copied
    there once (a copy from host memory cannot be recorded in a CUDA
    graph)."""
    return torch.as_tensor(subpixel_offsets(ss) * pixel_angle, dtype=dtype,
                           device=device)


def expand_subpixel(ro: torch.Tensor, rd: torch.Tensor, ss: int,
                    pixel_angle: float) -> tuple[torch.Tensor, torch.Tensor]:
    """[N,3] rays → [N*ss,3]: each ray becomes ``ss`` copies jittered over
    its pixel footprint (``pixel_angle`` radians square), pixel-major so
    sub-rays of one pixel stay adjacent (cull tiles keep their cones).

    The offsets are applied along an orthonormal basis perpendicular to
    the ray, not the camera's image axes: the packed rays carry no camera
    id, and for the area integral only the footprint's size matters.
    Sub-ray directions are re-normalized."""
    off = _subpixel_offsets_on(ss, pixel_angle, rd.dtype, rd.device)
    axes = torch.eye(3, dtype=rd.dtype, device=rd.device)
    up = torch.where(rd[:, 1:2].abs() < 0.9, axes[1][None, :],
                     axes[0][None, :])
    e1 = torch.linalg.cross(rd, up)
    e1 = e1 / torch.sqrt(torch.sum(e1 * e1, dim=1, keepdim=True))
    e2 = torch.linalg.cross(rd, e1)
    rdj = (rd[:, None, :]
           + off[None, :, 0, None] * e1[:, None, :]
           + off[None, :, 1, None] * e2[:, None, :])            # [N, ss, 3]
    rdj = rdj / torch.sqrt(torch.sum(rdj * rdj, dim=2, keepdim=True))
    roj = ro[:, None, :].expand(rdj.shape)
    return roj.reshape(-1, 3), rdj.reshape(-1, 3)


def uses_fused_shade(cfg: TrainConfig, march_normal_fn,
                     model_axis: Optional[Axis] = None) -> bool:
    """The K2 kernel hard-codes the reference compositor and dense tables:
    culled runs (``uses_fused_culled_shade``), M-sharded runs and other
    render configs take another tail."""
    rc = cfg.render
    return (march_normal_fn is not None and cfg.use_fused_shade
            and not cfg.use_culling and model_axis is None
            and rc.mask_pixel_mult == 0.0 and rc.coverage_mode == "sigmoid"
            and (rc.softmax_sharpness, rc.mask_sharpness) == (10.0, 15.0))


def uses_fused_culled_shade(cfg: TrainConfig, culled_march_fn,
                            model_axis: Optional[Axis] = None) -> bool:
    """The K6 kernel computes the culled tail on one whole table with
    sigmoid coverage and no pixel footprint (the two sharpness values are
    its arguments): model-sharded runs, the plain march and other render
    configs take render_diff_culled."""
    rc = cfg.render
    return (culled_march_fn is not None and cfg.use_fused_shade
            and cfg.use_culling and model_axis is None
            and rc.coverage_mode == "sigmoid"
            and (rc.mask_pixel_mult <= 0.0 or rc.pixel_angle <= 0.0))


def sample_step_indices(cfg: TrainConfig, generator: torch.Generator,
                        n_pixels: int, fg_indices: torch.Tensor, n_fg: int,
                        batch: int, uniform_ratio) -> torch.Tensor:
    """Batch pixel indices: i.i.d. pixels, or with ``sample_mode="tile"``
    whole ``cull_tile`` Morton blocks (fg_indices/n_fg at tile
    granularity, from RayDataset.tile_fg). ``uniform_ratio``: a float or a
    float32 tensor (data/dataset.sample_batch_indices)."""
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
    rs [B,K], qs [B,K] with 1e30 in invalid slots): flat selection through
    ``tile_select`` (K7 on CUDA tensors), hierarchical with ``clusters``."""
    if clusters is None:
        return tile_select(ro, rd, cfg.cull_tile, centers, radii, smooth_k,
                           cfg.cull_budget, mask)
    idx, valid = select_tile_primitives_hier(
        tile_cones(ro, rd, cfg.cull_tile), centers, radii, smooth_k,
        cfg.cull_budget, clusters, cfg.cull_cluster_budget, mask=mask)
    return (idx, valid) + selected_tables(centers, radii, idx, valid)


def sharded_culled_kernel_march(
        kern: Callable, model_axis: Axis,
        ro3: torch.Tensor, rd3: torch.Tensor, cs: torch.Tensor,
        rs: torch.Tensor, qs: torch.Tensor, smooth_k, *, num_steps: int,
        normal_eps: float, t_init: Optional[torch.Tensor] = None):
    """The culled march under an M-sharded table, through the single-table
    kernel ``kern`` (K3) → replicated (t [B,T,1], normal [B,T,3]).

    ro3, rd3 [B, T, 3] are the tile batch (the same on every rank of the
    axis); cs [B, K, 3], rs, qs [B, K] this shard's per-tile top-K tables.
    One all_to_all turns them into this rank's tile slice of the UNION
    table, [B/S, S·K]: the K-blocks it receives all describe its own tiles.
    The rank marches its B/S tiles against the union with ``kern`` (no
    collective inside the loop, the same (B/S)·(S·K) work per rank) and one
    all_gather returns the detached (t, normal). The union soft-min sums the
    same table entries as the pmax/psum soft-min (invalid slots carry zero
    weight), so the two agree up to summation order. B must divide by S, the
    axis size."""
    b = ro3.shape[0]
    bs = b // model_axis.size
    cs_u, rs_u, qs_u = (all_to_all(x, model_axis, split_dim=0, concat_dim=1)
                        for x in (cs, rs, qs))
    lo = model_axis.index * bs

    def own(x):
        return x[lo:lo + bs].contiguous()

    with torch.no_grad():
        t_loc, n_loc = kern(own(ro3), own(rd3), cs_u, rs_u, qs_u, smooth_k,
                            num_steps=num_steps, normal_eps=normal_eps,
                            t_init=None if t_init is None else own(t_init))
        return (all_gather(t_loc, model_axis, 0),
                all_gather(n_loc, model_axis, 0))


def culled_march_backend(culled_march_fn: Optional[Callable], b_t: int,
                         model_axis: Optional[Axis] = None) -> Callable:
    """The detached culled march for a batch of ``b_t`` tiles: without a
    kernel the plain march (under an M-sharded table its soft-min combines
    the shards at every step); the kernel directly on a single table; under
    an M-sharded table the union-table wrapper around it, which needs the
    tiles to split evenly over the axis (ValueError otherwise: the JAX
    package falls back to the plain march there, the port does not)."""
    if culled_march_fn is None:
        return functools.partial(culled_march_normals_xla,
                                 model_axis=model_axis)
    if model_axis is None:
        return culled_march_fn
    if b_t % model_axis.size:
        raise ValueError(f"{b_t} tiles do not split over the {model_axis.size}"
                         f" model ranks of the union-table march")
    return functools.partial(sharded_culled_kernel_march, culled_march_fn,
                             model_axis)


def make_device_step(cfg: TrainConfig, *, march_normal_fn: Optional[Callable],
                     batch: int, culled_march_fn: Optional[Callable] = None,
                     repulsion_fn: Optional[Callable] = None,
                     warm: bool = False, data_axis: Optional[Axis] = None,
                     model_axis: Optional[Axis] = None) -> Callable:
    """Build device_step(params, generator, stage, step, mask, packed,
    fg_indices, n_fg, idx=None, t_cache=None, clusters=None,
    rep_static=None) → (loss tensor, lr tensor).

    ``step`` is 1-based within the stage: an int, or an integer tensor on
    the dataset's device (what a captured step reads). The anneals are
    ``device_schedule``'s tensors; nothing is read back to the host, so
    the step can be recorded in a CUDA graph. The step leaves the
    gradients in ``params``' ``.grad``. ``idx`` injects the sampled batch
    indices (tests); culled steps sort them. With ``warm`` the march starts
    from ``warm_backoff`` × the cached t of each pixel and writes its result
    back into ``t_cache`` [P] in place. ``clusters`` (PrimitiveClusters)
    feeds hierarchical culling and the cluster repulsion; ``rep_static`` is
    the repulsion's frozen prep. ``culled_march_fn`` (K3) and
    ``repulsion_fn`` (K4) are the kernel wrappers; None takes the plain
    versions. ``batch`` is this rank's batch; ``data_axis`` / ``model_axis``
    as in the module docstring: all tensor
    arguments are then this rank's shards, and ``clusters`` is in the
    shard's own row ids. The step's phases are spans
    (utils/profiling.annotate: ``step.sample``, ``step.select``,
    ``step.march``, ``step.tail``, ``step.loss``, ``step.backward`` and,
    inside it over a data axis, ``step.grad_mean``); with the tracer on, a
    culled step adds its valid table entries to the tracer's device
    counter and 1 to its counter ``tail.fused`` (K6) or ``tail.plain``.
    """
    rc = cfg.render
    fused = uses_fused_shade(cfg, march_normal_fn, model_axis)
    fused_culled = uses_fused_culled_shade(cfg, culled_march_fn, model_axis)
    if model_axis is not None:
        repulsion_fn = None
        if march_normal_fn is not None and not cfg.use_culling:
            raise ValueError("K1 marches a whole table: a model-sharded dense "
                             "step takes no march_normal_fn")
    dense_warm = warm and march_normal_fn is not None and model_axis is None
    hier = cfg.use_culling and cfg.cull_hierarchical
    # Pixel-footprint supersampling (RenderConfig.supersample): batch/ss
    # unique pixels, each expanded into ss jittered sub-rays (the ray count
    # is unchanged), the prediction averaged per pixel before the loss.
    ss = int(rc.supersample)
    if ss > 1 and batch % ss:
        raise ValueError(f"batch ({batch}) must divide by supersample ({ss})")
    n_unique = batch // ss
    if cfg.sample_mode == "tile" and n_unique % cfg.cull_tile:
        raise ValueError(
            f"unique pixels/step ({n_unique}) must divide by cull_tile "
            f"({cfg.cull_tile}) — with supersample, batch must be a "
            f"multiple of supersample * cull_tile")

    def device_step(params: SceneParams, generator: torch.Generator,
                    stage: int, step: int, mask: torch.Tensor,
                    packed: torch.Tensor, fg_indices: torch.Tensor, n_fg: int,
                    idx: Optional[torch.Tensor] = None,
                    t_cache: Optional[torch.Tensor] = None, clusters=None,
                    rep_static=None):
        with annotate("step.sample"):
            if not torch.is_tensor(step):
                step = torch.tensor(step, device=packed.device)
            progress, smooth_k, uniform_ratio, lr = device_schedule(
                cfg, stage, step)
            if idx is None:
                idx = sample_step_indices(cfg, generator, packed.shape[0],
                                          fg_indices, n_fg, n_unique,
                                          uniform_ratio)
        with annotate("step.select"):
            if cfg.use_culling:
                # Sorted indices → tile-coherent rays; a with-replacement
                # sample is order-free, so the loss is unchanged.
                idx = torch.sort(idx).values
            ro, rd, tgt = gather_batch(packed, idx)
            if ss > 1:
                # Sub-rays are pixel-major-adjacent, so sorted unique pixels
                # stay tile-coherent after expansion; tgt stays per pixel.
                ro, rd = expand_subpixel(ro, rd, ss, rc.pixel_angle)

        culled_pre = None
        t = normal = None
        if cfg.use_culling or fused or dense_warm:
            with torch.no_grad():
                with annotate("step.select"):
                    c_det, _, r_det, _, _ = activate(params)
                    if cfg.use_culling:
                        idx_t, valid_t, cs, rs, qs = culled_tables(
                            cfg, ro, rd, c_det, r_det, smooth_k, mask,
                            clusters if hier else None)
                        TRACER.add_valid(valid_t)
                        TRACER.count("tiles", valid_t.shape[0])
                        TRACER.count("table_slots", valid_t.numel())
                with annotate("step.march"):
                    t0 = None
                    if warm:
                        t0 = t_cache[idx][:, None] * cfg.warm_backoff
                        if ss > 1:
                            # One cached root per pixel: its sub-rays share
                            # the warm start, the cache takes back their
                            # mean root.
                            t0 = t0.repeat_interleave(ss, dim=0)
                    if cfg.use_culling:
                        b_t = ro.shape[0] // cfg.cull_tile
                        tile_march = culled_march_backend(
                            culled_march_fn, b_t, model_axis)
                        t, normal = tile_march(
                            ro.reshape(b_t, cfg.cull_tile, 3),
                            rd.reshape(b_t, cfg.cull_tile, 3), cs, rs, qs,
                            smooth_k,
                            num_steps=(cfg.warm_steps if warm
                                       else rc.march_steps),
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
                        t_new = t.reshape(-1)
                        if ss > 1:
                            t_new = t_new.reshape(-1, ss).mean(dim=1)
                        t_cache[idx] = t_new

        with annotate("step.tail"):
            c_p, col_p, r_p, ld_p, amb_p = activate(params)
            if culled_pre is not None and fused_culled:
                TRACER.count("tail.fused")
                centers_t, colors_t, radii_t, _ = gather_tile_tables(
                    c_p, col_p, r_p, idx_t, valid_t)
                out = culled_shade(
                    ro.reshape(t.shape[0], cfg.cull_tile, 3),
                    rd.reshape(t.shape[0], cfg.cull_tile, 3), t, normal,
                    centers_t, colors_t, radii_t, valid_t, ld_p, amb_p,
                    smooth_k, rc.softmax_sharpness, rc.mask_sharpness)
            elif culled_pre is not None:
                TRACER.count("tail.plain")
                out = render_diff_culled(
                    ro, rd, c_p, col_p, r_p, ld_p, amb_p, smooth_k,
                    mask=mask, tile=cfg.cull_tile, k_budget=cfg.cull_budget,
                    num_steps=rc.march_steps,
                    softmax_sharpness=rc.softmax_sharpness,
                    mask_sharpness=rc.mask_sharpness,
                    normal_eps=rc.normal_eps, precomputed=culled_pre,
                    mask_pixel_mult=rc.mask_pixel_mult,
                    pixel_angle=rc.pixel_angle,
                    coverage_mode=rc.coverage_mode, model_axis=model_axis)
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
                                    coverage_mode=rc.coverage_mode,
                                    model_axis=model_axis)
        with annotate("step.loss"):
            if ss > 1:
                out = out.reshape(n_unique, ss, 3).mean(dim=1)
            loss = compute_loss(
                params, out, tgt, progress, mask=mask, cfg=cfg.loss,
                repulsion_clusters=clusters if cfg.cluster_repulsion else None,
                repulsion_fn=repulsion_fn,
                repulsion_static=rep_static if model_axis is None else None,
                model_axis=model_axis)
        with annotate("step.backward"):
            params.zero_grad(set_to_none=True)
            loss.backward()
            loss = loss.detach()
            if data_axis is not None:
                with annotate("step.grad_mean"):
                    loss = mean_grads(params.parameters(), data_axis,
                                      extra=loss)
        return loss, lr

    return device_step

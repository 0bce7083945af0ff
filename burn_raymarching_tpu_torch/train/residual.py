"""Per-primitive residual attribution for scale-aware density control (port
of burn_raymarching_tpu/train/residual.py).

The reference's split rule is an absolute radius threshold
(r > 0.25*0.65^stage), built for a handful of fat unit-scale spheres. On
prior-seeded compact clouds (radii ~0.02-0.1) it never fires. This module
supplies the replacement signal: attribute the rendered L1 residual to
primitives through the compositor weights, so density control can split
where the error is, independent of absolute scale.

For each scored ray i and primitive m in its per-tile top-K table:

    score[m] += softmax_weight[i, m] * coverage[i] * resid[i],
    resid[i]  = sum_c |render(i) - target(i)|

softmax_weight * coverage is d render / d color_m up to the lighting
factor. Scoring runs over a strided subsample of the training pixels at
stage boundaries, under ``torch.no_grad()``.

The scores feed an ``argsort`` (train/density.py), so they have to be
repeatable run to run: the per-tile contributions are not added with a
float-atomic ``index_add_``. Within one tile the top-K indices are distinct
(a prefix of a permutation of the rows, the plain sort's or K7's), so each
tile's row is written with ``scatter_`` into a [B, m_pad] buffer and the
rows are added with ``sum(0)``, a fixed-order reduction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.models.scene import SceneParams, activate
from burn_raymarching_tpu_torch.ops.cuda.tile_select_kernel import tile_select
from burn_raymarching_tpu_torch.ops.sdf import MASKED_NEG
from burn_raymarching_tpu_torch.render.culled import (
    _tile_dists,
    _tile_soft_min,
    culled_march_normals_xla,
)
from burn_raymarching_tpu_torch.render.diff import adaptive_coverage


@torch.no_grad()
def _score_chunk_culled(padded: SceneParams, mask: torch.Tensor,
                        ro: torch.Tensor, rd: torch.Tensor, tgt: torch.Tensor,
                        smooth_k: float, cfg: TrainConfig, kern=None
                        ) -> torch.Tensor:
    """One pixel chunk → partial scores [m_pad].

    Mirrors render_diff_culled's forward but also exposes the compositor
    weights and coverage for the attribution. ``kern`` is the K3 wrapper or
    None for the plain tile march."""
    rc = cfg.render
    tile = cfg.cull_tile
    m_pad = padded.centers.shape[0]
    centers_p, colors_p, radii_p, light_dir, ambient = activate(padded)
    idx_t, valid_t, cs, rs, qs = tile_select(
        ro, rd, tile, centers_p, radii_p, smooth_k, cfg.cull_budget, mask)
    cols = colors_p[idx_t]
    b = ro.shape[0] // tile
    ro3 = ro.reshape(b, tile, 3)
    rd3 = rd.reshape(b, tile, 3)
    march = kern if kern is not None else culled_march_normals_xla
    t, normal = march(ro3, rd3, cs, rs, qs, smooth_k,
                      num_steps=rc.march_steps, normal_eps=rc.normal_eps)
    # Reattachment point + shade tail.
    dist_last = _tile_soft_min(ro3 + rd3 * t, cs, rs, qs, smooth_k)
    t_final = t + dist_last
    p_final = ro3 + rd3 * t_final
    ld = light_dir / torch.sqrt(torch.sum(light_dir * light_dir))
    diffuse = torch.clamp(torch.sum(normal * ld[None, None, :], dim=2,
                                    keepdim=True), min=0.0)
    lighting = ambient + diffuse * (1.0 - ambient)
    dists = _tile_dists(p_final, cs, rs, qs)
    logits = torch.where(valid_t[:, None, :], dists * (-rc.softmax_sharpness),
                         torch.full_like(dists, MASKED_NEG))
    weights = torch.softmax(logits, dim=2)                      # [B, T, K]
    mixed = torch.bmm(weights, cols)
    dist_scene = _tile_soft_min(p_final, cs, rs, qs, smooth_k)
    cov = adaptive_coverage(dist_scene, t_final, rc.mask_sharpness,
                            rc.mask_pixel_mult, rc.pixel_angle,
                            coverage_mode=rc.coverage_mode)     # [B, T, 1]
    out = mixed * lighting * cov
    resid = torch.sum(torch.abs(out - tgt.reshape(b, tile, 3)), dim=2)
    contrib = torch.bmm(resid[:, None, :], weights * cov)[:, 0, :]   # [B, K]
    contrib = torch.where(valid_t, contrib, torch.zeros_like(contrib))
    rows = torch.zeros((b, m_pad), dtype=contrib.dtype, device=ro.device)
    rows.scatter_(1, idx_t, contrib)       # distinct indices per row: exact
    return rows.sum(dim=0)


@torch.no_grad()
def primitive_residual_scores(
    padded: SceneParams,
    mask: torch.Tensor,
    dataset,
    cfg: TrainConfig,
    smooth_k: float,
    kern=None,
    max_pixels: Optional[int] = None,
) -> np.ndarray:
    """Residual-attribution scores for every padded primitive slot → [M_pad].

    Scores a strided subsample (≤ ``max_pixels``, default
    DensityConfig.split_score_pixels) of the dataset's pixels in
    batch-size chunks. Requires a tile-coherent (Morton) dataset and a
    culling config. Two calls on the same inputs give the same bits."""
    ds = dataset
    if max_pixels is None:
        max_pixels = cfg.density.split_score_pixels
    if cfg.batch_size < cfg.cull_tile:
        raise ValueError(
            f"residual scoring needs batch_size ({cfg.batch_size}) >= "
            f"cull_tile ({cfg.cull_tile})")
    chunk = (cfg.batch_size // cfg.cull_tile) * cfg.cull_tile
    n = ds.num_total_pixels
    # Datasets smaller than one batch: clamp the slice to a whole-tile
    # prefix of the available pixels.
    chunk = min(chunk, (n // cfg.cull_tile) * cfg.cull_tile)
    if chunk == 0:
        raise ValueError(
            f"dataset has {n} pixels < one cull tile ({cfg.cull_tile})")
    n_chunks = max(n // chunk, 1)
    want = max(int(np.ceil(max_pixels / chunk)), 1)
    stride = max(n_chunks // want, 1)
    m_pad = padded.centers.shape[0]
    smooth_k = float(np.float32(smooth_k))
    scores = torch.zeros((m_pad,), dtype=torch.float32, device=ds.device)
    for ci in range(0, n_chunks, stride):
        rows = ds.packed[ci * chunk:(ci + 1) * chunk]
        scores = scores + _score_chunk_culled(
            padded, mask, rows[:, 0:3].contiguous(),
            rows[:, 3:6].contiguous(), rows[:, 6:9].contiguous(), smooth_k,
            cfg, kern)
    return scores.cpu().numpy()

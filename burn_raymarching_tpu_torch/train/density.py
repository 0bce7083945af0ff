"""Adaptive density control: generation-boundary pruning and splitting
(port of burn_raymarching_tpu/train/density.py).

Host-side NumPy, copied from the JAX package with the same
``np.random.default_rng`` draws, so results are bit-identical; the result
is re-padded to a bucket size before re-entering the training step. The
residual split mode takes its scores from train/residual.py.

Rules (reference lines cited):
  PRUNE  — r > 1 - 0.04*stage or r < 0.005 (training.rs:167)
           ||c||^2 > 1.44 (flyaway, training.rs:171-174)
           sum(sigmoid(colors)) < 0.05 (black, training.rs:177-180)
  SPLIT  — only before the last stage (training.rs:185):
           r > 0.25*0.65^stage AND moved^2 > 0.05^2 → two children at
           c ± dir*(r/2) with dir uniform on the sphere, child radius
           0.8*r (min 0.01) re-encoded through softplus⁻¹ = ln(e^x - 1)
           (training.rs:187-221); else keep as-is.
Movement is measured against the stage's INITIAL centers (training.rs:140-151).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from burn_raymarching_tpu_torch.config import DensityConfig


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _softplus_inv(y):
    """Inverse of softplus: ln(e^y - 1), clamped like the reference
    (training.rs:204: (target.exp() - 1).max(1e-6).ln())."""
    return np.log(np.maximum(np.expm1(y), 1e-6))


@dataclasses.dataclass
class DensityStats:
    pruned_size: int
    pruned_flyaway: int
    pruned_black: int
    split: int
    kept: int
    merged: int = 0


def merge_redundant(
    raw_centers: np.ndarray,   # [M, 3] raw
    raw_colors: np.ndarray,    # [M, 3] logits
    raw_radii: np.ndarray,     # [M, 1] raw
    cell: float,
    scores: np.ndarray | None = None,
):
    """Merge primitives sharing a quantized grid cell of size ``cell``.

    TPU-native density-control extension (DensityConfig.merge_cell; the
    reference has no overlap rule — its 6-7 fat spheres never stack).
    Prior-seeded clouds put ~25 primitives on each SfM point; a stack
    renders as one soft-min-inflated blob and multiplies every per-tile
    qualifying set by its depth. Per occupied cell the merge keeps:

      center — member mean (the stack's centroid),
      color  — member logit mean (≈ geometric-mean color, what the softmax
               compositor effectively shows for a tight stack),
      radius — the LARGEST member's (the stack's represented surface;
               training re-adjusts from there).

    With ``scores`` (residual attribution, train/residual.py) the merged
    cell's score is the member SUM — the stack's error mass stays intact
    for the split stage that follows — and a 5-tuple
    (centers, colors, radii, n_merged_away, scores) is returned.

    Returns (centers, colors, radii, n_merged_away[, scores]).
    """
    c = np.asarray(raw_centers, np.float32).reshape(-1, 3)
    if cell <= 0.0 or c.shape[0] == 0:
        if scores is not None:
            return raw_centers, raw_colors, raw_radii, 0, scores
        return raw_centers, raw_colors, raw_radii, 0
    q = np.floor(c / cell).astype(np.int64)
    # Collapse 3D cell coords to one key; 2^20 per axis is plenty.
    key = (q[:, 0] + (1 << 20) * (q[:, 1] + (1 << 20) * q[:, 2]))
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    k = uniq.shape[0]
    centers = np.zeros((k, 3), np.float32)
    colors = np.zeros((k, 3), np.float32)
    np.add.at(centers, inv, c)
    np.add.at(colors, inv, np.asarray(raw_colors, np.float32).reshape(-1, 3))
    centers /= counts[:, None]
    colors /= counts[:, None]
    # Raw radii are monotone under softplus, so the raw max IS the largest
    # physical radius.
    radii = np.full(k, -np.inf, np.float32)
    np.maximum.at(radii, inv, np.asarray(raw_radii, np.float32).reshape(-1))
    if scores is not None:
        s_out = np.zeros(k, np.float32)
        np.add.at(s_out, inv, np.asarray(scores, np.float32).reshape(-1))
        return centers, colors, radii[:, None], int(c.shape[0] - k), s_out
    return centers, colors, radii[:, None], int(c.shape[0] - k)


def _split_children(raw_centers, raw_colors, eval_radii, rng,
                    cfg: DensityConfig):
    """Two children per selected parent, the reference's placement rule
    (training.rs:191-221): c ± dir*(r/2) with dir uniform on the sphere,
    child radius 0.8*r (min 0.01) re-encoded through softplus⁻¹.

    Returns (centers [2S,3], colors [2S,3], radii [2S,1])."""
    n_split = raw_centers.shape[0]
    z = rng.uniform(-1.0, 1.0, size=n_split).astype(np.float32)
    theta = rng.uniform(0.0, 2.0 * np.pi, size=n_split).astype(np.float32)
    r_xy = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    d = np.stack([r_xy * np.cos(theta), r_xy * np.sin(theta), z], axis=1)
    offset = (eval_radii * 0.5)[:, None]
    child_r = _softplus_inv(
        np.maximum(eval_radii * cfg.split_child_radius_scale,
                   cfg.split_child_min_radius)
    )[:, None].astype(np.float32)
    centers = np.concatenate([raw_centers + d * offset,
                              raw_centers - d * offset])
    colors = np.concatenate([raw_colors, raw_colors])
    radii = np.concatenate([child_r, child_r])
    return centers, colors, radii


def prune_and_split(
    raw_centers: np.ndarray,   # [M, 3] raw
    raw_colors: np.ndarray,    # [M, 3] logits
    raw_radii: np.ndarray,     # [M, 1] raw
    init_centers: np.ndarray,  # [M, 3] stage-start centers
    stage: int,
    stages: int,
    rng: np.random.Generator,
    cfg: DensityConfig = DensityConfig(),
    split_scores: np.ndarray | None = None,
):
    """Returns (centers [M',3], colors [M',3], radii [M',1], stats).

    All arrays are raw (pre-activation) params for the next generation.

    ``split_scores`` ([M] residual attribution, train/residual.py) drives
    the scale-aware ``cfg.split_mode == "residual"`` rule: the reference's
    prune rules run unchanged, then the overlap merge (scores summed per
    cell), then the top-``split_budget`` scorers split — merge-before-split
    so fresh children survive the boundary they were born at.
    """
    raw_centers = np.asarray(raw_centers, np.float32).reshape(-1, 3)
    raw_colors = np.asarray(raw_colors, np.float32).reshape(-1, 3)
    raw_radii = np.asarray(raw_radii, np.float32).reshape(-1, 1)
    init_centers = np.asarray(init_centers, np.float32).reshape(-1, 3)

    eval_radii = _softplus(raw_radii[:, 0])                     # [M]
    eval_colors = _sigmoid(raw_colors)                          # [M, 3]

    # --- Pruning masks (training.rs:162-180) ---
    max_r = cfg.prune_max_radius_base - stage * cfg.prune_max_radius_decay
    bad_size = (eval_radii > max_r) | (eval_radii < cfg.prune_min_radius)
    dist_sq = (raw_centers ** 2).sum(axis=1)
    flyaway = dist_sq > cfg.prune_flyaway_dist_sq
    black = eval_colors.sum(axis=1) < cfg.prune_black_color_sum
    # Count prunes with the reference's short-circuit order (size, then
    # flyaway, then black).
    pruned_size = int(bad_size.sum())
    pruned_flyaway = int((~bad_size & flyaway).sum())
    pruned_black = int((~bad_size & ~flyaway & black).sum())
    keep = ~(bad_size | flyaway | black)

    if cfg.split_mode == "residual":
        if split_scores is None:
            raise ValueError('split_mode="residual" needs split_scores '
                             '(train/residual.primitive_residual_scores)')
        return _prune_merge_split_residual(
            raw_centers, raw_colors, raw_radii,
            np.asarray(split_scores, np.float32).reshape(-1), keep,
            pruned_size, pruned_flyaway, pruned_black,
            stage, stages, rng, cfg)

    # --- Splitting (training.rs:183-233) ---
    if stage < stages - 1:
        move_sq = ((raw_centers - init_centers) ** 2).sum(axis=1)
        threshold = cfg.split_radius_base * cfg.split_radius_decay ** stage
        split = keep & (eval_radii > threshold) & (
            move_sq > cfg.split_move_dist ** 2
        )
    else:
        split = np.zeros_like(keep)
    hold = keep & ~split

    out_centers = [raw_centers[hold]]
    out_colors = [raw_colors[hold]]
    out_radii = [raw_radii[hold]]

    n_split = int(split.sum())
    if n_split:
        # Uniform directions on the sphere, drawn per-split exactly like the
        # reference (z ~ U[-1,1), theta ~ U[0,tau)) (training.rs:191-199).
        cc, col2, rr = _split_children(
            raw_centers[split], raw_colors[split], eval_radii[split],
            rng, cfg)
        out_centers.append(cc)
        out_colors.append(col2)
        out_radii.append(rr)

    centers = np.concatenate(out_centers).astype(np.float32)
    colors = np.concatenate(out_colors).astype(np.float32)
    radii = np.concatenate(out_radii).astype(np.float32)

    merged = 0
    if cfg.merge_cell > 0.0:
        centers, colors, radii, merged = merge_redundant(
            centers, colors, radii, cfg.merge_cell)

    stats = DensityStats(
        pruned_size=pruned_size,
        pruned_flyaway=pruned_flyaway,
        pruned_black=pruned_black,
        split=n_split,
        kept=int(hold.sum()),
        merged=merged,
    )
    return centers, colors, radii, stats


def _prune_merge_split_residual(raw_centers, raw_colors, raw_radii,
                                scores, keep, pruned_size, pruned_flyaway,
                                pruned_black, stage, stages, rng,
                                cfg: DensityConfig):
    """Scale-aware boundary rules: prune (reference) → overlap merge →
    split the highest-residual primitives.

    The merge runs BEFORE the split (unlike the committed reference-mode
    order): children are placed at ± r/2 of small-radius parents, i.e.
    usually inside one merge cell, so the split-then-merge order would
    collapse fresh children right back — growth could never happen. Scores
    are summed through the merge, keeping each stack's error mass intact.
    """
    centers = raw_centers[keep]
    colors = raw_colors[keep]
    radii = raw_radii[keep]
    scores = scores[keep]

    merged = 0
    if cfg.merge_cell > 0.0:
        centers, colors, radii, merged, scores = merge_redundant(
            centers, colors, radii, cfg.merge_cell, scores=scores)

    n_split = 0
    n_hold = int(centers.shape[0])
    if stage < stages - 1 and centers.shape[0] > 0:
        budget = (cfg.split_budget if cfg.split_budget > 0
                  else int(cfg.split_frac * centers.shape[0]))
        order = np.argsort(-scores)[:budget]
        sel = np.zeros(centers.shape[0], bool)
        sel[order[scores[order] > 0.0]] = True
        n_split = int(sel.sum())
        hold = ~sel
        n_hold = int(hold.sum())
        out_centers = [centers[hold]]
        out_colors = [colors[hold]]
        out_radii = [radii[hold]]
        if n_split:
            cc, col2, rr = _split_children(
                centers[sel], colors[sel],
                _softplus(radii[sel][:, 0]), rng, cfg)
            out_centers.append(cc)
            out_colors.append(col2)
            out_radii.append(rr)
        centers = np.concatenate(out_centers)
        colors = np.concatenate(out_colors)
        radii = np.concatenate(out_radii)

    stats = DensityStats(
        pruned_size=pruned_size,
        pruned_flyaway=pruned_flyaway,
        pruned_black=pruned_black,
        split=n_split,
        kept=n_hold,
        merged=merged,
    )
    return (centers.astype(np.float32), colors.astype(np.float32),
            radii.astype(np.float32), stats)

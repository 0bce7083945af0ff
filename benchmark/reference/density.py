"""Density control at a stage boundary: a frozen copy of the program's
host-side rules (train/density.py: ``prune_and_split`` in its
``reference`` split mode, ``_split_children`` and ``merge_redundant``).

Prune (radius out of range, fly-away, black), split the large primitives
that moved (two children at c ± dir · r/2 with dir uniform on the sphere,
child radius 0.8 r re-encoded through softplus⁻¹), then merge the
primitives that share a grid cell of ``merge_cell`` (member mean of center
and color logits, the largest raw radius). The residual split mode is not
carried: ``check_config`` refuses a configuration that uses it.
"""

from __future__ import annotations

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _softplus_inv(y):
    return np.log(np.maximum(np.expm1(y), 1e-6))


def merge_redundant(raw_centers, raw_colors, raw_radii, cell: float):
    """→ (centers, colors, radii, n_merged_away)."""
    c = np.asarray(raw_centers, np.float32).reshape(-1, 3)
    if cell <= 0.0 or c.shape[0] == 0:
        return raw_centers, raw_colors, raw_radii, 0
    q = np.floor(c / cell).astype(np.int64)
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
    radii = np.full(k, -np.inf, np.float32)
    np.maximum.at(radii, inv, np.asarray(raw_radii, np.float32).reshape(-1))
    return centers, colors, radii[:, None], int(c.shape[0] - k)


def _split_children(raw_centers, raw_colors, eval_radii, rng, d):
    n_split = raw_centers.shape[0]
    z = rng.uniform(-1.0, 1.0, size=n_split).astype(np.float32)
    theta = rng.uniform(0.0, 2.0 * np.pi, size=n_split).astype(np.float32)
    r_xy = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    u = np.stack([r_xy * np.cos(theta), r_xy * np.sin(theta), z], axis=1)
    offset = (eval_radii * 0.5)[:, None]
    child_r = _softplus_inv(
        np.maximum(eval_radii * d.split_child_radius_scale,
                   d.split_child_min_radius))[:, None].astype(np.float32)
    centers = np.concatenate([raw_centers + u * offset,
                              raw_centers - u * offset])
    colors = np.concatenate([raw_colors, raw_colors])
    radii = np.concatenate([child_r, child_r])
    return centers, colors, radii


def prune_and_split(raw_centers, raw_colors, raw_radii, init_centers,
                    stage: int, stages: int, rng: np.random.Generator, d,
                    merge: bool = True):
    """→ (centers [M', 3], colors [M', 3], radii [M', 1], counts), all raw;
    ``counts`` holds ``kept``, ``split`` and ``merged``. ``merge=False``
    leaves the merge out (a planted fault of the checks)."""
    if d.split_mode != "reference":
        raise ValueError("the reference's density control has the "
                         "reference split mode only")
    raw_centers = np.asarray(raw_centers, np.float32).reshape(-1, 3)
    raw_colors = np.asarray(raw_colors, np.float32).reshape(-1, 3)
    raw_radii = np.asarray(raw_radii, np.float32).reshape(-1, 1)
    init_centers = np.asarray(init_centers, np.float32).reshape(-1, 3)
    eval_radii = _softplus(raw_radii[:, 0])
    eval_colors = _sigmoid(raw_colors)
    max_r = d.prune_max_radius_base - stage * d.prune_max_radius_decay
    bad_size = (eval_radii > max_r) | (eval_radii < d.prune_min_radius)
    flyaway = (raw_centers ** 2).sum(axis=1) > d.prune_flyaway_dist_sq
    black = eval_colors.sum(axis=1) < d.prune_black_color_sum
    keep = ~(bad_size | flyaway | black)
    if stage < stages - 1:
        move_sq = ((raw_centers - init_centers) ** 2).sum(axis=1)
        threshold = d.split_radius_base * d.split_radius_decay ** stage
        split = keep & (eval_radii > threshold) & (
            move_sq > d.split_move_dist ** 2)
    else:
        split = np.zeros_like(keep)
    hold = keep & ~split
    out_c, out_col, out_r = ([raw_centers[hold]], [raw_colors[hold]],
                             [raw_radii[hold]])
    n_split = int(split.sum())
    if n_split:
        cc, col2, rr = _split_children(raw_centers[split], raw_colors[split],
                                       eval_radii[split], rng, d)
        out_c.append(cc)
        out_col.append(col2)
        out_r.append(rr)
    centers = np.concatenate(out_c).astype(np.float32)
    colors = np.concatenate(out_col).astype(np.float32)
    radii = np.concatenate(out_r).astype(np.float32)
    merged = 0
    if merge and d.merge_cell > 0.0:
        centers, colors, radii, merged = merge_redundant(
            centers, colors, radii, d.merge_cell)
    return centers, colors, radii, {"kept": int(hold.sum()),
                                    "split": n_split, "merged": merged}

"""Derivative-free scene refinement: stochastic hill-climbing / annealing
(port of burn_raymarching_tpu/train/refine.py).

The trained large-scene recipes leave most of their residual error in the
silhouette band, where sub-pixel geometry is invisible to Adam (the
center-gradient valleys are narrow and shallow). This module climbs the
loss without gradients: perturb a random subset of primitives, keep the
proposal iff the weighted-L1 loss improves on BOTH of two disjoint fixed
ray batches. The batches must be large (two 65k-ray batches overfit;
262k-ray batches generalize), and the caller gates the result on a full
evaluation, which makes the procedure never-regress.

  * ``sigma_col`` — proposals jointly perturb the selected primitives' raw
    color logits;
  * ``light_refine`` — a separate micro-search over the global
    (light_dir, ambient) pair under the same two-batch gate;
  * ``fringe_weight`` — band-weighted acceptance: the two-batch loss
    upweights the dim-silhouette fringe (LossConfig.fringe_weight
    semantics);
  * ``accept_temp`` — Metropolis-style annealed acceptance: the chain may
    move uphill with probability exp(-Δ/T) (T annealed per phase, final
    phase greedy), while a separate best-seen snapshot only ever updates on
    strict two-batch improvement; the snapshot is what is returned.

Where the JAX package scans a chunk of proposals inside one device program,
this port runs a host loop under ``torch.no_grad()``: the accept decision
stays on the device (``torch.where`` on every leaf) and the accepted count
is read once per chunk, so the stream is never stalled per proposal.
``chunk`` is therefore the number of proposals between host reads.
``TrainConfig.refine_max_budget`` caps the cull budget of the
proposal-loss renders as in the JAX package (inactive at its default for
budgets up to 2,048); the acceptance loss is only an estimator, and the
caller's full-PSNR gate runs at the full budget.

The acceptance loss selects and marches its whole batch at once (the K3
kernel takes all its tiles in one launch) and evaluates the plain
gradient-free tail over ``TILE_SLICE`` tiles at a time, adding the partial
sums in slice order: one [tiles, rays, K] float32 intermediate of the tail
is tiles * 4 MiB at 512 rays and K = 2,048, and the tail holds several.

Random numbers come from an explicit ``torch.Generator``; ``draws`` replaces
them proposal by proposal (tests feed both packages the same noise).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.nn import functional as F

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.models.scene import SceneParams, activate
from burn_raymarching_tpu_torch.render.culled import (
    culled_march_normals_xla,
    render_diff_culled,
)
from burn_raymarching_tpu_torch.train.step_body import culled_tables

CHUNK = 64   # proposals between host reads of the accepted count
REFINE_MAX_BUDGET = 2048   # default of TrainConfig.refine_max_budget
TILE_SLICE = 64   # tiles per evaluation of the acceptance loss's tail


def _auto_chunk(k_budget: int) -> int:
    """Proposals between host reads, the JAX package's rule: CHUNK up to a
    budget of 2,048, halved as the budget doubles past it, at least 8."""
    return max(8, (CHUNK * 2048) // max(int(k_budget), 2048))


@dataclasses.dataclass
class RefineStats:
    loss_before: float
    loss_after: float
    accepted: int
    proposals: int


class Leaves(NamedTuple):
    """The five raw parameter tensors, detached: what a proposal chain
    carries (``activate`` reads them by name)."""

    centers: torch.Tensor
    colors: torch.Tensor
    radii: torch.Tensor
    light_dir: torch.Tensor
    ambient: torch.Tensor


def _leaves(params) -> Leaves:
    return Leaves(*(getattr(params, k).detach() for k in Leaves._fields))


def _where(cond: torch.Tensor, new: Leaves, old: Leaves) -> Leaves:
    return Leaves(*(torch.where(cond, b, a) for a, b in zip(old, new)))


def fg_tile_batch_indices(dataset, tiles: int, seed: int = 0,
                          tile: int = 512, n_batches: int = 2
                          ) -> list[np.ndarray]:
    """Sorted pixel indices of ``n_batches`` disjoint foreground-tile
    batches (the JAX package's ``rng.choice`` draw)."""
    rng = np.random.default_rng(seed)
    fg_t, n_t = dataset.tile_fg(tile)
    fg_ids = fg_t.cpu().numpy()[: int(n_t)]
    if fg_ids.size < n_batches:
        raise ValueError(
            f"dataset has {fg_ids.size} fg tiles < n_batches ({n_batches})")
    # An underfilled pool would leave the hold-out batch short or empty:
    # divide what is available evenly instead.
    tiles = min(tiles, fg_ids.size // n_batches)
    pick = rng.choice(fg_ids, size=n_batches * tiles, replace=False)
    return [np.sort((pick[b * tiles:(b + 1) * tiles][:, None] * tile
                     + np.arange(tile)[None, :]).reshape(-1))
            for b in range(n_batches)]


def sample_fg_tile_batches(dataset, tiles: int, seed: int = 0,
                           tile: int = 512, n_batches: int = 2):
    """``n_batches`` DISJOINT fg-tile ray batches [(ro, rd, tgt), ...] on the
    dataset's device.

    Foreground tiles only (RayDataset.tile_fg): background-only tiles
    carry no silhouette signal. The second batch is the hold-out of the
    acceptance test."""
    out = []
    for idx in fg_tile_batch_indices(dataset, tiles, seed, tile, n_batches):
        rows = dataset.packed[torch.as_tensor(idx, device=dataset.device)]
        out.append((rows[:, 0:3].contiguous(), rows[:, 3:6].contiguous(),
                    rows[:, 6:9].contiguous()))
    return out


def _make_loss_on(cfg: TrainConfig, mask, kern, k_budget: int,
                  fringe_weight: float, tile_slice: int = TILE_SLICE):
    """The acceptance estimator: weighted-L1 on a fixed ray batch through
    the culled renderer (the weights of the final training progress;
    ``fringe_weight`` > 1 also upweights the dim-silhouette band) → a
    0-d tensor on the batch's device.

    Selection and the detached march (``kern``: the K3 wrapper, or None for
    the plain tile march) cover the whole batch at once; the tail runs over
    ``tile_slice`` tiles at a time and the weighted sums are added in slice
    order, so the result depends on the slice size by float32 rounding
    only."""
    rc = cfg.render
    lc = cfg.loss
    tile = cfg.cull_tile
    smooth_k = float(np.float32(cfg.max_smooth_k))
    march = kern if kern is not None else culled_march_normals_xla
    cull_cfg = dataclasses.replace(cfg, cull_budget=k_budget)

    @torch.no_grad()
    def loss_on(params, ro, rd, tgt):
        c, col, r, ld, amb = activate(params)
        idx, valid, cs, rs, qs = culled_tables(cull_cfg, ro, rd, c, r,
                                               smooth_k, mask)
        b = ro.shape[0] // tile
        t, normal = march(ro.reshape(b, tile, 3), rd.reshape(b, tile, 3),
                          cs, rs, qs, smooth_k, num_steps=40,
                          normal_eps=1e-4)
        total = torch.zeros((), dtype=torch.float32, device=ro.device)
        for s in range(0, b, tile_slice):
            e = min(s + tile_slice, b)
            rows = slice(s * tile, e * tile)
            out = render_diff_culled(
                ro[rows], rd[rows], c, col, r, ld, amb, smooth_k, mask=mask,
                tile=tile, k_budget=k_budget,
                softmax_sharpness=rc.softmax_sharpness,
                mask_sharpness=rc.mask_sharpness,
                coverage_mode=rc.coverage_mode,
                mask_pixel_mult=rc.mask_pixel_mult,
                pixel_angle=rc.pixel_angle,
                precomputed=(idx[s:e], valid[s:e], t[s:e], normal[s:e]))
            tg = tgt[rows]
            tsum = torch.sum(tg, dim=1, keepdim=True)
            obj = tsum > lc.fg_mask_threshold
            w = torch.where(obj, lc.fg_weight, lc.bg_weight_end)
            if fringe_weight != 1.0:
                fringe = obj & (tsum < lc.fringe_threshold)
                w = torch.where(fringe, w * fringe_weight, w)
            total = total + torch.sum(torch.abs(out - tg) * w)
        return total / float(tgt.numel())

    return loss_on


def _capped_budget(cfg: TrainConfig, log) -> int:
    cap = int(getattr(cfg, "refine_max_budget", REFINE_MAX_BUDGET))
    k_budget = min(cfg.cull_budget, cap)
    if k_budget < cfg.cull_budget:
        log(f"  refine: proposal-loss cull budget capped "
            f"{cfg.cull_budget} -> {k_budget} (refine_max_budget; "
            f"acceptance is an estimator — the caller's full-PSNR gate "
            f"runs at the full budget)")
    return k_budget


def _resolve_chunk(chunk: Optional[int], k_budget: int) -> int:
    if chunk is None:
        return _auto_chunk(k_budget)
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return int(chunk)


def _to_dev(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=like.device)


def selection_probs(mask: torch.Tensor, frac: float, select_probs=None
                    ) -> torch.Tensor:
    """[M_pad, 1] probability that a proposal perturbs each slot: ``frac``
    everywhere, or ∝ ``select_probs`` on the live slots with the expected
    selected count held at ``frac``·N_live (before clipping at 1)."""
    live = mask.to(torch.float32)
    if select_probs is None:
        return torch.full((mask.shape[0], 1), frac, dtype=torch.float32,
                          device=mask.device)
    w = torch.clamp(_to_dev(select_probs, live), min=0.0) * live
    n_live = torch.clamp(torch.sum(live), min=1.0)
    p_sel = torch.clamp(frac * n_live * w
                        / torch.clamp(torch.sum(w), min=1e-20), 0.0, 1.0)
    return p_sel[:, None]


def geometry_refine(
    padded: SceneParams,
    mask: torch.Tensor,
    batches,                       # [(ro, rd, tgt), (ro, rd, tgt)] disjoint
    cfg: TrainConfig,
    *,
    kern=None,                     # the K3 wrapper, or None (plain march)
    proposals: int = 768,
    phases: int = 3,
    frac: float = 0.05,
    sigma_c: float = 0.3,          # in units of each primitive's radius
    sigma_r: float = 0.15,         # raw (softplus-domain) radius noise
    sigma_col: float = 0.0,        # raw (sigmoid-logit) color noise; 0 = off
    accept_temp: float = 0.0,      # Metropolis temperature (x baseline loss)
    fringe_weight: float = 1.0,    # acceptance-loss band weighting
    select_probs=None,             # [M_pad] proposal bias
    generator: Optional[torch.Generator] = None,
    draws: Optional[Callable] = None,
    chunk: Optional[int] = None,   # proposals per host read; None = auto
    log=print,
) -> tuple[SceneParams, RefineStats]:
    """Hill-climb (centers, radii[, colors]) on the two-batch-gated loss.

    Light stays fixed (see ``light_refine``). Each phase halves the noise
    scale. The caller should gate the returned params on a full evaluation.

    ``select_probs`` biases which primitives each proposal perturbs:
    per-primitive selection probability ∝ the given weights with the
    expected selected count held at ``frac``·N_live (uniform Bernoulli
    when None).

    ``accept_temp`` > 0 runs the proposal chain with Metropolis acceptance
    on the worst-batch loss delta (T = accept_temp × the baseline loss,
    halved each phase, forced greedy in the final phase) while a separate
    best-seen snapshot updates only on strict two-batch improvement; the
    snapshot is what is returned.

    ``draws(chunk_index, i)`` → (u [M,1], n_centers [M,3], n_radii [M,1],
    n_colors [M,3], u_metropolis scalar) replaces the generator's noise for
    proposal ``i`` of the ``chunk_index``-th chunk (chunks counted across
    phases); ``n_colors`` is read only when ``sigma_col`` > 0 and
    ``u_metropolis`` only when ``accept_temp`` > 0.
    """
    (ro_a, rd_a, tgt_a), (ro_b, rd_b, tgt_b) = batches
    dev = padded.centers.device
    k_budget = _capped_budget(cfg, log)
    m_pad = padded.centers.shape[0]
    live = mask.to(torch.float32)[:, None]
    p_sel = selection_probs(mask, frac, select_probs)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed)
    if draws is None:
        def draws(_chunk_index, _i):
            def randn(*shape):
                return torch.randn(shape, generator=generator, device=dev)
            return (torch.rand((m_pad, 1), generator=generator, device=dev),
                    randn(m_pad, 3), randn(m_pad, 1),
                    randn(m_pad, 3) if sigma_col > 0.0 else None,
                    torch.rand((), generator=generator, device=dev)
                    if accept_temp > 0.0 else None)

    loss_on = _make_loss_on(cfg, mask, kern, k_budget, fringe_weight)
    csize = _resolve_chunk(chunk, k_budget)

    def perturb(params: Leaves, noise, sigma_scale: float) -> Leaves:
        """One proposal: Gaussian noise on the selected live primitives'
        centers (radius-scaled), raw radii and (optionally) raw colors."""
        u, n_c, n_r, n_col, _ = noise
        r_phys = F.softplus(params.radii) + 0.01
        sel = (_to_dev(u, live) < p_sel).to(torch.float32) * live
        colors = params.colors
        if sigma_col > 0.0:
            colors = colors + (_to_dev(n_col, live)
                               * sigma_col * sigma_scale * sel)
        return Leaves(
            centers=params.centers
            + _to_dev(n_c, live) * sigma_c * sigma_scale * r_phys * sel,
            colors=colors,
            radii=params.radii
            + _to_dev(n_r, live) * sigma_r * sigma_scale * sel,
            light_dir=params.light_dir, ambient=params.ambient)

    @torch.no_grad()
    def propose_chunk(best, chunk_index, sigma_scale):
        """Greedy chain: current == best (accept_temp == 0)."""
        params, best_a, best_b = best
        n_acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(csize):
            cand = perturb(params, draws(chunk_index, i), sigma_scale)
            l_a = loss_on(cand, ro_a, rd_a, tgt_a)
            l_b = loss_on(cand, ro_b, rd_b, tgt_b)
            acc = (l_a < best_a) & (l_b < best_b)
            params = _where(acc, cand, params)
            best_a = torch.where(acc, l_a, best_a)
            best_b = torch.where(acc, l_b, best_b)
            n_acc = n_acc + acc
        return (params, best_a, best_b), n_acc

    @torch.no_grad()
    def propose_chunk_annealed(cur, best, chunk_index, sigma_scale, temp):
        """Metropolis chain (worst-batch Δ) + strict-improvement best
        snapshot. ``temp`` <= 0 reduces the chain move to greedy."""
        cur_params, cur_a, cur_b = cur
        best_params, best_a, best_b = best
        n_acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(csize):
            noise = draws(chunk_index, i)
            cand = perturb(cur_params, noise, sigma_scale)
            l_a = loss_on(cand, ro_a, rd_a, tgt_a)
            l_b = loss_on(cand, ro_b, rd_b, tgt_b)
            delta = torch.maximum(l_a - cur_a, l_b - cur_b)
            mv = delta < 0.0
            if temp > 0.0:
                u = _to_dev(noise[4], live)
                mv = mv | (u < torch.exp(-delta / max(temp, 1e-20)))
            cur_params = _where(mv, cand, cur_params)
            cur_a = torch.where(mv, l_a, cur_a)
            cur_b = torch.where(mv, l_b, cur_b)
            imp = (l_a < best_a) & (l_b < best_b)
            best_params = _where(imp, cand, best_params)
            best_a = torch.where(imp, l_a, best_a)
            best_b = torch.where(imp, l_b, best_b)
            n_acc = n_acc + imp
        return ((cur_params, cur_a, cur_b), (best_params, best_a, best_b),
                n_acc)

    start = _leaves(padded)
    best_a = loss_on(start, ro_a, rd_a, tgt_a)
    best_b = loss_on(start, ro_b, rd_b, tgt_b)
    l0 = float(best_a)
    best = (start, best_a, best_b)
    cur = best
    accepted = 0
    total = 0
    chunk_index = 0
    n_chunks = max(proposals // csize, 1)
    for ph in range(phases):
        scale = float(np.float32(0.5 ** ph))
        # Annealed chain temperature: relative to the baseline loss, halved
        # per phase, forced greedy in the final phase so the chain
        # re-converges before the round gate.
        temp = (float(np.float32(accept_temp * l0 * (0.5 ** ph)))
                if (accept_temp > 0.0 and ph < phases - 1) else 0.0)
        ph_acc = 0
        for _ in range(n_chunks):
            if accept_temp > 0.0:
                cur, best, acc = propose_chunk_annealed(
                    cur, best, chunk_index, scale, temp)
            else:
                best, acc = propose_chunk(best, chunk_index, scale)
                cur = best
            chunk_index += 1
            ph_acc += int(acc)       # the one host read of the chunk
            total += csize
        accepted += ph_acc
        log(f"  refine phase {ph}: loss {float(best[1]):.5f}, "
            f"accepted {ph_acc}/{n_chunks * csize}")
    leaves, best_a, _ = best
    return SceneParams(*leaves), RefineStats(
        loss_before=l0, loss_after=float(best_a), accepted=accepted,
        proposals=total)


def light_refine(
    padded: SceneParams,
    mask: torch.Tensor,
    batches,
    cfg: TrainConfig,
    *,
    kern=None,
    proposals: int = 64,
    phases: int = 2,
    sigma_dir: float = 0.1,        # raw light_dir noise
    sigma_amb: float = 0.1,        # raw ambient-logit noise
    fringe_weight: float = 1.0,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Callable] = None,
    log=print,
) -> tuple[SceneParams, RefineStats]:
    """Two-batch-gated micro-search over the GLOBAL (light_dir, ambient).

    The pair is first-order-trainable, but after geometry refinement has
    moved silhouettes the shading optimum shifts and Adam is no longer
    running: this closes that gap with the same greedy two-batch gate.
    Geometry and colors stay fixed. ``draws(chunk_index, i)`` → (n_dir [3],
    n_amb [1]) replaces the generator's noise."""
    (ro_a, rd_a, tgt_a), (ro_b, rd_b, tgt_b) = batches
    dev = padded.centers.device
    k_budget = _capped_budget(cfg, log)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed)
    if draws is None:
        def draws(_chunk_index, _i):
            return (torch.randn((3,), generator=generator, device=dev),
                    torch.randn((1,), generator=generator, device=dev))
    loss_on = _make_loss_on(cfg, mask, kern, k_budget, fringe_weight)
    csize = min(_auto_chunk(k_budget), proposals)

    params = _leaves(padded)
    best_a = loss_on(params, ro_a, rd_a, tgt_a)
    best_b = loss_on(params, ro_b, rd_b, tgt_b)
    l0 = float(best_a)
    accepted = 0
    total = 0
    chunk_index = 0
    with torch.no_grad():
        for ph in range(phases):
            scale = float(np.float32(0.5 ** ph))
            ph_acc = 0
            for _ in range(max(proposals // csize, 1)):
                n_acc = torch.zeros((), dtype=torch.int64, device=dev)
                for i in range(csize):
                    n_dir, n_amb = draws(chunk_index, i)
                    cand = params._replace(
                        light_dir=params.light_dir
                        + _to_dev(n_dir, best_a) * sigma_dir * scale,
                        ambient=params.ambient
                        + _to_dev(n_amb, best_a) * sigma_amb * scale)
                    l_a = loss_on(cand, ro_a, rd_a, tgt_a)
                    l_b = loss_on(cand, ro_b, rd_b, tgt_b)
                    acc = (l_a < best_a) & (l_b < best_b)
                    params = _where(acc, cand, params)
                    best_a = torch.where(acc, l_a, best_a)
                    best_b = torch.where(acc, l_b, best_b)
                    n_acc = n_acc + acc
                chunk_index += 1
                ph_acc += int(n_acc)
                total += csize
            accepted += ph_acc
            log(f"  light-refine phase {ph}: loss {float(best_a):.5f}, "
                f"accepted {ph_acc}")
    return SceneParams(*params), RefineStats(
        loss_before=l0, loss_after=float(best_a), accepted=accepted,
        proposals=total)

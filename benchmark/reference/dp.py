"""The data-parallel step of the reference: the training step of
``step.py`` on D data ranks, computed in one process.

The deployment (``docs/SCALING.md``'s data axis, as the program's
``parallel/DistributedTrainer`` runs it at model 1): every rank holds the
whole table and trains on its own contiguous pixel shard. For each data
rank r of D this computes

* the rank's shard: rows r·P/D .. (r+1)·P/D − 1 of the dataset and its
  shard-local foreground set (tile-granular under tile sampling);
* the rank's sampling generator: the stage's sub-key folded with r
  (``fold_key``, written out here);
* the rank's batch of B/D rays, drawn from its shard;
* the warm start's cache of the shard, prefilled by the reference's own
  cold culled march (of the tiles the checked steps draw);
* the loss and its gradient on the shard.

Then the mean of the D losses and gradients (equal shards: the mean of
shard means is the batch mean), one plain Adam step, and at a stage
boundary the reference's density control (``density.py``) on the
replicated table.

Departures from ``docs/SCALING.md``'s data axis, as the program has them:

* the rows are sorted into Morton order of their centers at every stage
  start, and the cluster table is consecutive groups of G of the sorted,
  padded rows (the slot count a multiple of G), where the single-card
  trainer builds its clusters by ``build_clusters``;
* the repulsion's prep (cluster centroids' near tables) is computed in
  each step from the live centers, never frozen at a chunk start;
* the mean of the gradients and the loss is one sum over the ranks
  divided by D (the program: one all-reduce of the flattened gradients and
  the loss), not a ``pmean`` per leaf;
* the foreground boost samples each shard's own foreground tiles.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .adam import PlainAdam
from .culling import PrimitiveClusters, morton_order
from .data import anneal_k, as_dtype, split_key
from .padding import bucket_size
from .scene import SceneParams, pad_params
from .step import (
    cold_march_tiles,
    device_schedule,
    lr_scale_tree,
    sample_step_indices,
    step_loss,
)

LEAVES = ("centers", "colors", "radii", "light_dir", "ambient")
# Planted faults of the data-parallel step: half of each rank's batch,
# and each replica stepping on its own shard's gradient (rank 0's).
FAULTS = ("half_batch", "skip_mean")


def fold_key(key: np.ndarray, data: int) -> np.ndarray:
    """A key [2] uint32 folded with the data index → key [2] uint32 (the
    program's ``train/loop.fold_key``)."""
    return np.random.default_rng([int(x) for x in key] + [int(data)]
                                 ).integers(0, 2 ** 32, size=2,
                                            dtype=np.uint32)


def rank_generator(seed: int, stage: int, rank: int, ranks: int,
                   device) -> torch.Generator:
    """Data rank ``rank``'s sampling generator of a run's ``stage``: the
    stage's sub-key of the key [0, seed], folded with the rank where the
    data axis is wider than one."""
    key = np.asarray([0, seed], np.uint32)
    for _ in range(stage + 1):
        key, sub = split_key(key)
    if ranks > 1:
        sub = fold_key(sub, rank)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(sub[0]) << 32) | int(sub[1]))
    return gen


class Shard:
    """One data rank's contiguous pixel shard of ``rows`` (``data.Rows``):
    its packed rows and the pool its sampler draws from, in shard-local
    ids."""

    def __init__(self, cfg, rows, rank: int, ranks: int):
        if rows.n % ranks:
            raise ValueError(f"{rows.n} pixels do not split over {ranks} "
                             f"data ranks")
        self.n = rows.n // ranks
        self.lo = rank * self.n
        self.packed = rows.packed[self.lo:self.lo + self.n]
        tgt = self.packed[:, 6:9].float().cpu().numpy()
        dev = rows.packed.device
        if cfg.sample_mode == "tile":
            if self.n % cfg.cull_tile:
                raise ValueError(f"a shard of {self.n} pixels holds no whole "
                                 f"number of {cfg.cull_tile}-ray tiles")
            any_fg = (tgt.sum(axis=1) > cfg.fg_pixel_threshold).reshape(
                -1, cfg.cull_tile).any(axis=1)
        else:
            any_fg = tgt.sum(axis=1) > cfg.fg_pixel_threshold
        ids = np.nonzero(any_fg)[0].astype(np.int32)
        pool = np.zeros((any_fg.shape[0],), np.int32)
        pool[:ids.size] = ids
        self.fg_pool = torch.as_tensor(pool, device=dev)
        self.n_fg = int(ids.size)


def shards(cfg, rows, ranks: int) -> list[Shard]:
    return [Shard(cfg, rows, r, ranks) for r in range(ranks)]


def stage_table(params: SceneParams, group: Optional[int],
                dtype=torch.float32
                ) -> tuple[SceneParams, torch.Tensor,
                           Optional[PrimitiveClusters]]:
    """The table a data-parallel stage starts from, in ``dtype`` →
    (padded, mask, cluster table). With a cluster ``group`` (the cluster
    repulsion's G) the live rows of ``params`` are sorted into Morton
    order of their centers, padded to a slot count that holds whole groups
    and grouped consecutively; without one they are padded as they come
    and there is no cluster table."""
    live = params
    if group:
        order = torch.as_tensor(morton_order(
            params.centers.detach().float().cpu().numpy()),
            device=params.centers.device)
        live = SceneParams(*(getattr(params, k).detach()[order]
                             for k in ("centers", "colors", "radii")),
                           params.light_dir.detach(), params.ambient.detach())
    slots = bucket_size(live.n)
    while group and slots % group:
        slots *= 2
    padded, mask = pad_params(live, slots)
    padded = as_dtype(padded, dtype)
    clusters = None
    if group:
        clusters = PrimitiveClusters(
            torch.arange(slots, device=mask.device).reshape(-1, group),
            mask.reshape(-1, group))
    return padded, mask, clusters


def rank_batch(cfg, ranks: int) -> int:
    batch = cfg.batch_size // ranks
    if batch * ranks != cfg.batch_size:
        raise ValueError(f"batch {cfg.batch_size} does not split over "
                         f"{ranks} data ranks")
    return batch


def draw_rank(cfg, gen: torch.Generator, stage: int, step: int,
              shard: Shard, batch: int) -> torch.Tensor:
    """The shard-local batch indices a rank draws at a 1-based step."""
    step_t = torch.tensor(step, device=shard.fg_pool.device)
    _, _, uniform_ratio, _ = device_schedule(cfg, stage, step_t)
    return sample_step_indices(cfg, gen, shard.n, shard.fg_pool, shard.n_fg,
                               batch, uniform_ratio)


def prefill_tiles(cfg, shard: Shard, padded, mask, stage: int, draws: list,
                  dtype=torch.float64) -> torch.Tensor:
    """The shard's warm-start cache with the tiles of ``draws`` prefilled
    by the cold culled march at the stage's first smooth_k (the rest
    stays 0; no step reads it) → [shard pixels]."""
    dev = shard.packed.device
    packed = shard.packed.to(dtype)
    t_cache = torch.zeros((shard.n,), dtype=dtype, device=dev)
    tiles = torch.unique(torch.cat(draws) // cfg.cull_tile)
    k0 = anneal_k(cfg, stage, 1)
    per = cfg.batch_size // cfg.cull_tile
    for i in range(0, tiles.numel(), per):
        pix = (tiles[i:i + per, None] * cfg.cull_tile + torch.arange(
            cfg.cull_tile, device=dev)[None, :]).reshape(-1)
        t_cache[pix] = cold_march_tiles(
            cfg, packed[pix, 0:3].contiguous(), packed[pix, 3:6].contiguous(),
            padded, mask, k0)
    return t_cache


def shard_losses(cfg, padded, mask, clusters, stage: int, step: int,
                 parts: list, draws: list, t_caches: list,
                 keep: Optional[slice] = None) -> tuple[list, torch.Tensor]:
    """Each rank's loss on its own batch at a 1-based step (the repulsion's
    prep computed from the live centers) → ([loss of rank r], lr)."""
    losses, lr = [], None
    for r, shard in enumerate(parts):
        loss, lr = step_loss(cfg, padded, stage, step, mask,
                             shard.packed.to(padded.centers.dtype),
                             draws[r], t_caches[r],
                             clusters if cfg.cluster_repulsion else None,
                             None, keep=keep)
        losses.append(loss)
    return losses, lr


def shard_grads(losses: list, padded) -> list[dict]:
    """The gradient of each rank's loss, leaf by leaf."""
    leaves = [getattr(padded, k) for k in LEAVES]
    out = []
    for loss in losses:
        gs = torch.autograd.grad(loss, leaves, retain_graph=True,
                                 allow_unused=True)
        out.append({k: torch.zeros_like(p) if g is None else g
                    for k, p, g in zip(LEAVES, leaves, gs)})
    return out


def mean_grads(grads: list) -> dict:
    """The mean over the ranks of their gradients."""
    return {k: sum(g[k] for g in grads) / len(grads) for k in LEAVES}


def dp_steps(cfg, rows, padded, mask, clusters, stage: int, n_steps: int,
             ranks: int, device, dtype=torch.float64,
             fault: Optional[str] = None) -> dict:
    """The first ``n_steps`` data-parallel steps of ``stage`` from the
    stage-start table (``stage_table``) → each step's loss (the mean over
    the ranks), every rank's draws (rank-major, step by step), the
    parameters at the start (``p0``) and after the last step (``p3``) and
    the gradient as Adam holds it after the first step. ``fault`` plants
    "half_batch" (each rank's loss over half of its batch) or "skip_mean"
    (no mean over the ranks: the replica of rank 0 steps on its own
    shard's loss and gradient)."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"no fault {fault!r} in the data-parallel step")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = rank_batch(cfg, ranks)
    parts = shards(cfg, rows, ranks)
    draws = []
    for r, shard in enumerate(parts):
        gen = rank_generator(cfg.seed, stage, r, ranks, device)
        draws.append([draw_rank(cfg, gen, stage, s, shard, batch)
                      for s in range(1, n_steps + 1)])
    t_caches = [None] * ranks
    if cfg.warm_start:
        t_caches = [prefill_tiles(cfg, shard, padded, mask, stage, draws[r],
                                  dtype)
                    for r, shard in enumerate(parts)]
    leaves = {k: getattr(padded, k) for k in LEAVES}
    opt = PlainAdam(leaves, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
                    cfg.weight_decay, cfg.weight_decay_mode)
    scales = lr_scale_tree(cfg, stage)
    keep = slice(0, batch // 2) if fault == "half_batch" else None
    out = {"losses": [],
           "draws": [d.cpu() for per in draws for d in per],
           "p0": {k: v.detach().clone().double().cpu()
                  for k, v in leaves.items()}}
    for s in range(1, n_steps + 1):
        for p in leaves.values():
            p.grad = None
        losses, lr = shard_losses(cfg, padded, mask, clusters, stage, s,
                                  parts, [d[s - 1] for d in draws], t_caches,
                                  keep)
        loss = losses[0] if fault == "skip_mean" else sum(losses) / ranks
        loss.backward()
        opt.step({k: lr * scales[k] for k in LEAVES})
        out["losses"].append(float(loss.detach()))
        if s == 1:
            out["grad"] = {k: opt.moment_grad(k).detach().double().cpu()
                           for k in LEAVES}
    out["p3"] = {k: v.detach().clone().double().cpu()
                 for k, v in leaves.items()}
    return out

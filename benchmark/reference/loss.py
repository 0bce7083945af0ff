"""Training loss: weighted L1 reconstruction + 4 geometric penalties (port of
burn_raymarching_tpu/train/loss.py::compute_loss, dense path).

Padded primitive slots contribute nothing, and every "mean over
primitives" divides by the number of valid primitives.
  1. recon: |out - target| weighted 10 on object pixels (target sum > 0.01),
     background weight annealed 1 → 5 with progress (optional fringe boost);
  2. radius: 0.04 mean(r^2 where r > 1) + 0.002 mean(|r|), r = softplus(raw);
  3. origin attraction: 0.05 mean(centers^2);
  4. camera-proximity barrier: 5 mean(max(0, ||c|| + r - 1.2)^2);
  5. pairwise repulsion: 1e-5 mean(1/(dist + 100 I + 1e-6)), exact O(M^2),
     or with ``repulsion_clusters`` the two-level cluster approximation
     (``cluster_repulsion``, the plain version of the K4 kernel in
     ops/cuda/repulsion_kernel.py).

With ``model_axis`` (a parallel.collectives.Axis, primitives sharded over
the ranks) every mean over primitives sums its shard terms over the axis
and divides by the summed count; the exact repulsion sums each shard's
[M_local, M] row block against the gathered centers (the diagonal at the
shard's offset); the cluster repulsion keeps its near field within the
shard's own clusters and takes every other cluster, remote ones included,
as a monopole through the gathered centroids and counts. The K4 kernel
sees a whole cluster table, so the sharded loss uses the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from .config import LossConfig
from .scene import SceneParams
from .collectives import (
    Axis,
    all_gather,
    psum,
    pvary,
)


class RepulsionStatic(NamedTuple):
    """The non-differentiable half of the two-level repulsion's prep, frozen
    between refreshes: neighbor-cluster ids are top-k indices, and validity,
    counts and far weights depend only on the cluster table and the mask.
    Freezing them only lags which cluster pairs get the exact near field;
    member positions, centroids and neighbor positions stay live."""

    nb: torch.Tensor        # [C, W] int64 near-cluster ids (own included)
    nbm_idx: torch.Tensor   # [C, W·G] int64 neighbor-member primitive ids
    nb_w: torch.Tensor      # [C, W·G] f32 neighbor-member validity
    far_w: torch.Tensor     # [C, C] f32 (1 - near_hot) * counts row weights
    counts: torch.Tensor    # [C] f32 live members per cluster
    w: torch.Tensor         # [C, G] f32 member validity


def _member_weights(clusters, mask: Optional[torch.Tensor]) -> torch.Tensor:
    valid = clusters.member_valid
    if mask is not None:
        valid = valid & mask.bool()[clusters.member_idx]
    return valid.to(torch.float32)


def _centroids(cs: torch.Tensor, w: torch.Tensor, counts: torch.Tensor
               ) -> torch.Tensor:
    return (torch.sum(cs * w[..., None], dim=1)
            / torch.clamp(counts, min=1.0)[:, None])


def centroid_d2(centroids: torch.Tensor, counts: torch.Tensor
                ) -> torch.Tensor:
    """[C, C] squared centroid distances, +inf on empty clusters' columns."""
    cd2 = torch.sum((centroids[:, None, :] - centroids[None, :, :]) ** 2,
                    dim=2)
    return torch.where((counts > 0)[None, :], cd2,
                       torch.full_like(cd2, float("inf")))


def near_tables(member_idx: torch.Tensor, w: torch.Tensor,
                counts: torch.Tensor, cd2: torch.Tensor, w_near: int):
    """W nearest clusters per cluster → (nb [C, W], neighbor-member ids
    [C, W·G], their validity [C, W·G], far weights [C, C])."""
    c_count, g = member_idx.shape
    # Stable sort: ties (empty clusters' +inf) go to the lower index, as in
    # jax.lax.top_k.
    nb = torch.sort(cd2, dim=1, stable=True).indices[:, :w_near]
    nbm = member_idx[nb].reshape(c_count, w_near * g)
    nb_w = w[nb].reshape(c_count, w_near * g)
    near_hot = torch.sum(F.one_hot(nb, c_count).to(w.dtype), dim=1)
    return nb, nbm, nb_w, (1.0 - near_hot) * counts[None, :]


@torch.no_grad()
def build_repulsion_static(centers: torch.Tensor, clusters,
                           mask: Optional[torch.Tensor],
                           near_clusters: int = 8) -> RepulsionStatic:
    """Freeze the repulsion prep from the current centers. With the same
    centers the static path reproduces the live path exactly."""
    member_idx = clusters.member_idx
    c_count, g = member_idx.shape
    w = _member_weights(clusters, mask)
    counts = torch.sum(w, dim=1)
    cs = centers.detach()[member_idx.reshape(-1)].reshape(c_count, g, 3)
    cd2 = centroid_d2(_centroids(cs, w, counts), counts)
    nb, nbm, nb_w, far_w = near_tables(member_idx, w, counts, cd2,
                                       min(near_clusters, c_count))
    return RepulsionStatic(nb, nbm, nb_w, far_w, counts, w)


def cluster_repulsion(centers: torch.Tensor, clusters,
                      mask: Optional[torch.Tensor], n_valid,
                      near_clusters: int = 8, far_field: str = "member",
                      static: Optional[RepulsionStatic] = None,
                      model_axis: Optional[Axis] = None) -> torch.Tensor:
    """Barnes-Hut approximation of the pairwise repulsion mean (plain
    version of K4): exact 1/(d + 100·I + 1e-6) over pairs whose clusters are
    among the ``near_clusters`` nearest by centroid (own included), centroid
    monopoles for the rest. ``far_field`` "member" evaluates every member
    against every far centroid ([M, C] pairs); "monopole" collapses both
    sides to centroids ([C, C] pairs). Gradients flow through member
    positions and the centroids. ``static`` supplies the frozen prep (one
    whole table only). With ``model_axis`` the arguments are this rank's
    shard (member ids in its own row space) and the result is replicated
    (module docstring)."""
    member_idx = clusters.member_idx
    c_count, g = member_idx.shape
    if static is not None and model_axis is not None:
        raise ValueError("static repulsion tables are single-table only "
                         "(the sharded loss computes its prep in-step)")
    if static is not None:
        w, counts, nb = static.w, static.counts, static.nb
        nbm_flat, nb_w, far_w_rows = static.nbm_idx, static.nb_w, static.far_w
        w_near = nb.shape[1]
        cd2 = None
    else:
        w = _member_weights(clusters, mask).to(centers.dtype)
        counts = torch.sum(w, dim=1)
        w_near = min(near_clusters, c_count)
    cs = centers[member_idx.reshape(-1)].reshape(c_count, g, 3)
    centroids = _centroids(cs, w, counts)                    # [C, 3]
    if static is None:
        cd2 = centroid_d2(centroids, counts)
        nb, nbm_flat, nb_w, far_w_rows = near_tables(
            member_idx, w, counts, cd2.detach(), w_near)

    # Exact near-field pairs, +100 on true self-pairs.
    nb_cs = cs[nb].reshape(c_count, w_near * g, 3)
    d2 = torch.sum((cs[:, :, None, :] - nb_cs[:, None, :, :]) ** 2, dim=3)
    dist = torch.sqrt(torch.clamp(d2, min=1e-6))             # [C, G, W·G]
    self_pair = member_idx[:, :, None] == nbm_flat.reshape(c_count, 1, -1)
    inv = 1.0 / (dist + self_pair.to(dist.dtype) * 100.0 + 1e-6)
    s_near = torch.sum(inv * w[:, :, None] * nb_w[:, None, :])

    # Far field: monopoles of every cluster but the W near ones. Under a
    # sharded M the remote shards' centroids arrive gathered and are always
    # monopoles.
    cents_all = centroids
    if model_axis is not None:
        cents_all = pvary(all_gather(centroids, model_axis), model_axis)
        counts_all = all_gather(counts.detach(), model_axis)
        near_hot = torch.sum(F.one_hot(
            nb + model_axis.index * c_count, cents_all.shape[0]).to(w.dtype),
            dim=1)
        far_w_rows = (1.0 - near_hot) * counts_all[None, :]
    c_all = cents_all.shape[0]
    if far_field == "monopole":
        if model_axis is not None:
            ccd2 = torch.sum((centroids[:, None, :] - cents_all[None, :, :])
                             ** 2, dim=2)
        else:
            ccd2 = cd2 if cd2 is not None else centroid_d2(centroids, counts)
        inv_cc = 1.0 / (torch.sqrt(torch.clamp(ccd2, min=1e-6)) + 1e-6)
        s_far = torch.sum(far_w_rows * counts[:, None] * inv_cc)
    else:
        diff = cs.reshape(c_count * g, 1, 3) - cents_all[None, :, :]
        dist_f = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=2),
                                        min=1e-6))           # [C·G, C_all]
        inv_f = 1.0 / (dist_f + 1e-6)
        far_w = far_w_rows[:, None, :].expand(c_count, g, c_all).reshape(
            c_count * g, c_all)
        s_far = torch.sum(inv_f * w.reshape(-1)[:, None] * far_w)
    s = s_near + s_far
    if model_axis is not None:
        s = psum(s, model_axis)
    return s / (n_valid * n_valid)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                 n_valid, model_axis: Optional[Axis] = None) -> torch.Tensor:
    """Mean over valid primitive slots; plain mean when unmasked. With
    ``model_axis`` x/mask are one shard: the sum is summed over the axis
    and ``n_valid`` is already the global count."""
    if mask is None and model_axis is None:
        return torch.mean(x)
    s = torch.sum(x if mask is None else x * mask.to(x.dtype).reshape(
        (-1,) + (1,) * (x.dim() - 1)))
    if model_axis is not None:
        s = psum(s, model_axis)
    return s / (n_valid * (x.numel() // x.shape[0]))


def compute_loss(params: SceneParams, output: torch.Tensor,
                 target: torch.Tensor, progress,
                 mask: Optional[torch.Tensor] = None,
                 cfg: LossConfig = LossConfig(), repulsion_clusters=None,
                 repulsion_fn=None,
                 repulsion_static: Optional[RepulsionStatic] = None,
                 model_axis: Optional[Axis] = None) -> torch.Tensor:
    """Scalar training loss. ``repulsion_clusters`` (PrimitiveClusters)
    switches term 5 to the two-level repulsion, computed by
    ``repulsion_fn`` (the K4 wrapper) when given and by
    ``cluster_repulsion`` otherwise; ``repulsion_static`` is the frozen
    prep. With ``model_axis`` the primitive rows of ``params``, ``mask``
    and the clusters are this rank's shard, ``output``/``target`` are
    replicated, and so is the loss (module docstring); the K4 kernel and
    the frozen prep are single-table only and are not used then."""
    # --- 1. Weighted L1 reconstruction ---
    abs_diff = torch.abs(output - target)
    target_sum = torch.sum(target, dim=1, keepdim=True)
    object_mask = target_sum > cfg.fg_mask_threshold
    bg_weight = cfg.bg_weight_start + progress * (
        cfg.bg_weight_end - cfg.bg_weight_start)
    # bg_weight is a tensor when progress is (the training step's).
    weight_map = torch.where(object_mask, cfg.fg_weight, bg_weight)
    if cfg.fringe_weight != 1.0:
        fringe = object_mask & (target_sum < cfg.fringe_threshold)
        weight_map = torch.where(fringe, weight_map * cfg.fringe_weight,
                                 weight_map)
    loss = torch.mean(abs_diff * weight_map)

    n_valid = (torch.sum(mask.to(output.dtype)) if mask is not None
               else float(params.centers.shape[0]))
    ax = model_axis
    if ax is not None:
        n_valid = psum(torch.as_tensor(n_valid, dtype=output.dtype,
                                       device=output.device), ax)

    # --- 2. Radius penalties (no +0.01 here) ---
    radii = F.softplus(params.radii)
    radius_l1 = _masked_mean(torch.abs(radii), mask, n_valid, ax)
    radius_large = _masked_mean(
        torch.where(radii > 1.0, radii * radii, torch.zeros_like(radii)),
        mask, n_valid, ax)
    loss = (loss + radius_large * cfg.radius_large_coeff
            + radius_l1 * cfg.radius_l1_coeff)

    # --- 3. Origin attraction ---
    center_sq = params.centers * params.centers
    loss = loss + _masked_mean(center_sq, mask, n_valid, ax) * cfg.center_coeff

    # --- 4. Camera-proximity barrier ---
    dist_from_origin = torch.sqrt(
        torch.sum(center_sq, dim=1, keepdim=True) + 1e-6)
    max_reach = dist_from_origin + radii
    excess = max_reach - cfg.proximity_bound
    proximity = torch.where(max_reach > cfg.proximity_bound, excess * excess,
                            torch.zeros_like(excess))
    loss = (loss + _masked_mean(proximity, mask, n_valid, ax)
            * cfg.proximity_coeff)

    # --- 5. Pairwise repulsion ---
    if repulsion_clusters is not None:
        if repulsion_fn is not None and ax is None:
            repulsion = repulsion_fn(params.centers, repulsion_clusters, mask,
                                     n_valid,
                                     far_field=cfg.repulsion_far_field,
                                     static=repulsion_static)
        else:
            repulsion = cluster_repulsion(
                params.centers, repulsion_clusters, mask, n_valid,
                far_field=cfg.repulsion_far_field, model_axis=ax,
                static=repulsion_static if ax is None else None)
        return loss + repulsion * cfg.repulsion_coeff
    # Sharded: this rank's [M_local, M] row block against the gathered
    # centers, the diagonal at the shard's row offset.
    c = params.centers
    c_all, mask_all, eye = c, mask, None
    if ax is not None:
        c_all = pvary(all_gather(c, ax), ax)
        mask_all = None if mask is None else all_gather(mask, ax)
        rows = (torch.arange(c.shape[0], device=c.device)
                + ax.index * c.shape[0])
        eye = (rows[:, None] == torch.arange(c_all.shape[0],
                                             device=c.device)[None, :]
               ).to(c.dtype)
    else:
        eye = torch.eye(c.shape[0], dtype=c.dtype, device=c.device)
    c_sq = torch.sum(c * c, dim=1, keepdim=True)              # [M, 1]
    ca_sq = c_sq.T if ax is None else torch.sum(c_all * c_all, dim=1)[None, :]
    dist_sq = c_sq + ca_sq - 2.0 * (c @ c_all.T)
    dist = torch.sqrt(torch.clamp(dist_sq, min=1e-6))
    inv = 1.0 / (dist + eye * 100.0 + 1e-6)
    if mask is None and ax is None:
        repulsion = torch.mean(inv)
    else:
        s = (torch.sum(inv) if mask is None else torch.sum(
            inv * (mask.to(c.dtype)[:, None]
                   * mask_all.to(c.dtype)[None, :])))
        if ax is not None:
            s = psum(s, ax)
        repulsion = s / (n_valid * n_valid)
    return loss + repulsion * cfg.repulsion_coeff

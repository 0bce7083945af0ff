"""Coherent-tile primitive culling for large scenes (port of
burn_raymarching_tpu/ops/culling.py).

Rays in a tile share a bounding cone; a primitive farther than
``CULL_MARGIN / k`` from the cone (beyond its radius) contributes less than
exp(-22) relative to the soft-min/softmax sums, below float32 resolution,
so each tile marches against its own top-K primitive table instead of all
M. Selection is dense [n_tiles, M] geometry without transcendentals and
carries no gradient. ``jax.lax.top_k`` becomes a stable sort, which breaks
ties toward the lower index as ``top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from burn_raymarching_tpu_torch.utils.device import resolve_device

# exp(-22) ≈ 2.7e-10: dropped terms are below f32 resolution of the sums.
CULL_MARGIN = 22.0


class TileCones(NamedTuple):
    apex: torch.Tensor           # [B, 3] mean ray origin per tile
    axis: torch.Tensor           # [B, 3] unit mean direction
    cos_half: torch.Tensor       # [B] cos of the bounding half-angle
    origin_spread: torch.Tensor  # [B] max |origin - apex| (cutoff inflation)


def _norm(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def tile_cones(ray_org: torch.Tensor, ray_dir: torch.Tensor,
               tile: int) -> TileCones:
    """Bounding cones of consecutive ray tiles. N must divide by ``tile``."""
    b = ray_org.shape[0] // tile
    ro = ray_org.reshape(b, tile, 3)
    rd = ray_dir.reshape(b, tile, 3)
    apex = torch.mean(ro, dim=1)
    axis = torch.mean(rd, dim=1)
    axis = axis / torch.clamp(_norm(axis, 1, keepdim=True), min=1e-12)
    cos_half = torch.amin(torch.sum(rd * axis[:, None, :], dim=2), dim=1)
    # A tile spanning > 90° gets cos_half <= 0: the cone test below then
    # keeps everything, which is safe.
    spread = torch.amax(_norm(ro - apex[:, None, :], 2), dim=1)
    return TileCones(apex, axis, torch.clamp(cos_half, -1.0, 1.0), spread)


def _cone_distance_core(cones: TileCones, v: torch.Tensor) -> torch.Tensor:
    """Point-to-cone distance for per-tile offsets v [B, X, 3] → [B, X].

    Inside the cone (α ≤ θ) 0; else |v|·sin(min(α−θ, π/2)), computed
    trig-free: sin(α−θ) = sinα·cosθ − cosα·sinθ, and cos(α−θ) < 0 means
    the distance is |v|.
    """
    length = _norm(v, 2)                                        # [B, X]
    proj = torch.sum(v * cones.axis[:, None, :], dim=2)         # [B, X]
    cosa = torch.clamp(proj / torch.clamp(length, min=1e-12), -1.0, 1.0)
    sina = torch.sqrt(torch.clamp(1.0 - cosa * cosa, min=0.0))
    cost = cones.cos_half[:, None]
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    sin_out = torch.clamp(sina * cost - cosa * sint, min=0.0)   # sin(α−θ) ∨ 0
    cos_diff = cosa * cost + sina * sint                        # cos(α−θ)
    d = torch.where(cos_diff < 0.0, length, length * sin_out)
    return torch.where(length < 1e-9, torch.zeros_like(d), d)


def cone_point_distance(cones: TileCones, points: torch.Tensor
                        ) -> torch.Tensor:
    """Distance from each shared point [M, 3] to each tile's cone → [B, M]."""
    return _cone_distance_core(cones, points[None, :, :]
                               - cones.apex[:, None, :])


def _cutoff(cones: TileCones, smooth_k) -> torch.Tensor:
    return CULL_MARGIN / smooth_k + cones.origin_spread[:, None]


def _top_k_smallest(ranked: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries per row → (indices int64, finite mask).

    Ties go to the lower index, as in ``jax.lax.top_k``: primitives inside
    a cone all score −radius, and the cloud init gives them one radius, so
    an overflowing tile keeps the same set as the JAX package. A stable
    sort gives that order; ``torch.topk`` does not promise one.
    """
    vals, idx = torch.sort(ranked, dim=1, stable=True)
    return idx[:, :k], torch.isfinite(vals[:, :k])


@torch.no_grad()
def select_tile_primitives(cones: TileCones, centers: torch.Tensor,
                           radii: torch.Tensor, smooth_k, k_budget: int,
                           mask: Optional[torch.Tensor] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K primitive indices per tile → (idx [B, K] int64, valid [B, K]).

    Keeps primitives whose cone distance minus radius is within the cutoff;
    when more than K qualify, the K nearest are kept.
    """
    score = cone_point_distance(cones, centers) - radii.reshape(1, -1)
    keep = score <= _cutoff(cones, smooth_k)
    if mask is not None:
        keep = keep & mask[None, :].bool()
    ranked = torch.where(keep, score, torch.full_like(score, float("inf")))
    return _top_k_smallest(ranked, min(k_budget, centers.shape[0]))


@torch.no_grad()
def selection_overflow(cones: TileCones, centers: torch.Tensor,
                       radii: torch.Tensor, smooth_k, k_budget: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-tile count of qualifying primitives dropped by the K budget.
    Nonzero means the render is no longer f32-exact."""
    d = cone_point_distance(cones, centers)
    keep = (d - radii.reshape(1, -1)) <= _cutoff(cones, smooth_k)
    if mask is not None:
        keep = keep & mask[None, :].bool()
    return torch.clamp(keep.sum(dim=1) - k_budget, min=0)


class PrimitiveClusters(NamedTuple):
    """Fixed cluster membership for hierarchical selection and the
    two-level repulsion. Membership is rebuilt at stage boundaries; the
    cluster bounds are recomputed from the live centers every step."""

    member_idx: torch.Tensor    # [C, G] int64 primitive ids (pad: slot 0)
    member_valid: torch.Tensor  # [C, G] bool


def morton3(q: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave 3×``bits`` quantized coords → Z-order code (uint64)."""
    code = np.zeros(q.shape[0], dtype=np.uint64)
    q = q.astype(np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= (((q[:, axis] >> np.uint64(b)) & np.uint64(1))
                     << np.uint64(3 * b + axis))
    return code


def morton_order(centers) -> np.ndarray:
    """Host-side Z-order permutation of points (argsort of morton3 codes)."""
    c = np.asarray(centers)
    lo, hi = c.min(axis=0), c.max(axis=0)
    scale = np.maximum(hi - lo, 1e-9)
    q = np.clip(((c - lo) / scale * 1023.0), 0, 1023).astype(np.uint64)
    return np.argsort(morton3(q), kind="stable")


def build_clusters(centers, mask=None, group: int = 64,
                   device: torch.device | str = "cuda") -> PrimitiveClusters:
    """Morton-sort live primitive centers (NumPy, host side) and chunk them
    into clusters of ``group``; the last cluster is padded with invalid
    slots pointing at primitive 0."""
    device = resolve_device(device)
    centers = np.asarray(centers)
    m = centers.shape[0]
    live = (np.ones(m, bool) if mask is None
            else np.asarray(mask).astype(bool))
    ids = np.nonzero(live)[0]
    if ids.size == 0:
        ids = np.zeros(1, np.int64)
    sorted_ids = ids[morton_order(centers[ids])]
    n = sorted_ids.size
    c_count = max(1, -(-n // group))
    pad = c_count * group - n
    member = np.concatenate([sorted_ids, np.zeros(pad, np.int64)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return PrimitiveClusters(
        torch.as_tensor(member.reshape(c_count, group), device=device),
        torch.as_tensor(valid.reshape(c_count, group), device=device))


def _member_valid(clusters: PrimitiveClusters,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    valid = clusters.member_valid
    if mask is not None:
        valid = valid & mask.bool()[clusters.member_idx]
    return valid


def _bounds(mc: torch.Tensor, mr: torch.Tensor, valid: torch.Tensor):
    """Bounding spheres of member centers [C, G, 3] and radii [C, G]."""
    w = valid.to(mc.dtype)[..., None]
    count = torch.clamp(torch.sum(w, dim=1), min=1.0)            # [C, 1]
    bc = torch.sum(mc * w, dim=1) / count                        # [C, 3]
    reach = _norm(mc - bc[:, None, :], 2) + mr
    br = torch.amax(torch.where(valid, reach,
                                torch.full_like(reach, float("-inf"))),
                    dim=1)                                       # [C]
    return bc, br


@torch.no_grad()
def cluster_bounds(clusters: PrimitiveClusters, centers: torch.Tensor,
                   radii: torch.Tensor, mask: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cluster bounding spheres → (center [C,3], radius [C], valid
    [C,G]). Each member sphere lies inside its cluster's sphere, so the
    coarse cull lower-bounds every member's fine score (exact)."""
    valid = _member_valid(clusters, mask)
    mc = centers[clusters.member_idx]                            # [C, G, 3]
    mr = radii.reshape(-1)[clusters.member_idx]                  # [C, G]
    bc, br = _bounds(mc, mr, valid)
    return bc, br, valid


@torch.no_grad()
def select_tile_primitives_hier(cones: TileCones, centers: torch.Tensor,
                                radii: torch.Tensor, smooth_k, k_budget: int,
                                clusters: PrimitiveClusters,
                                cluster_budget: int,
                                mask: Optional[torch.Tensor] = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level top-K selection → (idx [B, K] int64, valid [B, K]).

    Cluster bounding spheres are tested first and the ``cluster_budget``
    nearest qualifying clusters kept; only their members are scored with the
    flat rule. Identical to flat selection whenever the qualifying clusters
    fit the budget.
    """
    member_valid = _member_valid(clusters, mask)
    c_count, g = clusters.member_idx.shape
    flat = clusters.member_idx.reshape(-1)
    centers_s = centers[flat].reshape(c_count, g, 3)
    radii_s = radii.reshape(-1)[flat].reshape(c_count, g)
    bc, br = _bounds(centers_s, radii_s, member_valid)

    cutoff = _cutoff(cones, smooth_k)
    coarse = cone_point_distance(cones, bc) - br[None, :]        # [B, C]
    keep_c = (coarse <= cutoff) & torch.any(member_valid, dim=1)[None, :]
    ranked_c = torch.where(keep_c, coarse,
                           torch.full_like(coarse, float("inf")))
    cidx, c_alive = _top_k_smallest(ranked_c, min(cluster_budget, c_count))

    b = cidx.shape[0]
    cand_idx = clusters.member_idx[cidx].reshape(b, -1)          # [B, Q]
    cand_valid = (member_valid[cidx] & c_alive[..., None]).reshape(b, -1)
    pts = centers_s[cidx].reshape(b, -1, 3)
    cand_r = radii_s[cidx].reshape(b, -1)

    score = _cone_distance_core(cones, pts - cones.apex[:, None, :]) - cand_r
    keep = (score <= cutoff) & cand_valid
    ranked = torch.where(keep, score, torch.full_like(score, float("inf")))
    qidx, valid = _top_k_smallest(ranked, min(k_budget, cand_idx.shape[1]))
    return torch.gather(cand_idx, 1, qidx), valid


@torch.no_grad()
def cluster_overflow(cones: TileCones, centers: torch.Tensor,
                     radii: torch.Tensor, smooth_k,
                     clusters: PrimitiveClusters, cluster_budget: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-tile count of qualifying CLUSTERS dropped by the cluster budget."""
    bc, br, member_valid = cluster_bounds(clusters, centers, radii, mask)
    coarse = cone_point_distance(cones, bc) - br[None, :]
    keep = ((coarse <= _cutoff(cones, smooth_k))
            & torch.any(member_valid, dim=1)[None, :])
    return torch.clamp(keep.sum(dim=1) - cluster_budget, min=0)


def gather_tile_tables(centers: torch.Tensor, colors: torch.Tensor,
                       radii: torch.Tensor, idx: torch.Tensor,
                       valid: torch.Tensor):
    """Per-tile primitive tables (differentiable in centers/colors/radii) →
    (centers_t [B,K,3], colors_t [B,K,3], radii_t [B,K], c_sq_t [B,K] with
    1e30 in invalid slots)."""
    centers_t = centers[idx]                                     # [B, K, 3]
    colors_t = colors[idx]
    radii_t = radii.reshape(-1)[idx]                             # [B, K]
    c_sq = torch.sum(centers_t * centers_t, dim=2)
    c_sq = torch.where(valid, c_sq, torch.full_like(c_sq, 1e30))
    return centers_t, colors_t, radii_t, c_sq


def selected_tables(centers: torch.Tensor, radii: torch.Tensor,
                    idx: torch.Tensor, valid: torch.Tensor):
    """The march's per-tile tables of a selection → (cs [B,K,3], rs [B,K],
    qs [B,K]: |c|² with 1e30 in invalid slots)."""
    cs = centers[idx]
    rs = radii.reshape(-1)[idx]
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    return cs, rs, qs

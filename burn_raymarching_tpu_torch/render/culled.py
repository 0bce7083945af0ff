"""Differentiable renderer with coherent-tile primitive culling (port of
burn_raymarching_tpu/render/culled.py).

Same forward model and gradient topology as render/diff.py, but every field
evaluation runs against per-tile top-K tables (ops/culling.py) instead of
the full [N, M] matrix. Rays must be tile-coherent: Morton pixel order for
rendering, sorted indices for training batches.

``culled_march_normals_xla`` is the plain PyTorch version of the K3 kernel
(ops/cuda/culled_march_kernel.py). The gradient-carrying tail of
``render_diff_culled`` stays plain autograd, as the JAX package keeps it in
XLA.

With ``model_axis`` (a parallel.collectives.Axis) the primitive arguments
are this rank's shard of an M-sharded table and every rank selects its own
per-tile top-K over its own rows: the soft-min and softmax combine the
shards' tables with a detached max and summed exp sums, as render/diff.py
does over whole shards.
"""

from __future__ import annotations

from typing import Optional

import torch

from burn_raymarching_tpu_torch.ops.culling import (
    PrimitiveClusters,
    gather_tile_tables,
    select_tile_primitives,
    select_tile_primitives_hier,
    tile_cones,
)
from burn_raymarching_tpu_torch.ops.march import T_MAX
from burn_raymarching_tpu_torch.ops.sdf import MASKED_NEG
from burn_raymarching_tpu_torch.parallel.collectives import (
    Axis,
    pmax,
    psum,
    pvary,
)
from burn_raymarching_tpu_torch.render.diff import (
    adaptive_coverage,
    sharded_softmax,
)


def _tile_dists(p, centers_t, radii_t, c_sq_t):
    """[B, T, K] surface distances (expanded form)."""
    p_sq = torch.sum(p * p, dim=2, keepdim=True)                # [B, T, 1]
    dot = torch.bmm(p, centers_t.transpose(1, 2))               # [B, T, K]
    d_sq = p_sq + c_sq_t[:, None, :] - 2.0 * dot
    return torch.sqrt(torch.clamp(d_sq, min=1e-6)) - radii_t[:, None, :]


def _tile_soft_min(p, centers_t, radii_t, c_sq_t, k,
                   model_axis: Optional[Axis] = None):
    """[B, T, 1] LogSumExp soft-min: d first, then ·(−k), detached row max.
    Invalid slots carry |c|² = 1e30, so their weight is exactly zero. With
    ``model_axis`` the tables are per-shard selections: the max is reduced
    (detached) and the exp sum summed over the shards."""
    val = _tile_dists(p, centers_t, radii_t, c_sq_t) * (-k)
    mx = torch.amax(val, dim=2, keepdim=True).detach()
    if model_axis is not None:
        mx = pmax(mx, model_axis)
    s = torch.sum(torch.exp(val - mx), dim=2, keepdim=True)
    if model_axis is not None:
        s = psum(s, model_axis)
    return (torch.log(torch.clamp(s, min=1e-8)) + mx) / (-k)


def _tile_normals(p, centers_t, radii_t, c_sq_t, k, eps: float = 1e-4,
                  model_axis: Optional[Axis] = None):
    """6-tap central differences per tile → [B, T, 3], with +1e-6 inside
    the normalising sqrt."""
    taps = []
    for axis in range(3):
        off = torch.zeros((1, 1, 3), dtype=p.dtype, device=p.device)
        off[0, 0, axis] = eps
        taps.append(_tile_soft_min(p + off, centers_t, radii_t, c_sq_t, k,
                                   model_axis)
                    - _tile_soft_min(p - off, centers_t, radii_t, c_sq_t, k,
                                     model_axis))
    normal = torch.cat(taps, dim=2)                             # [B, T, 3]
    length = torch.sqrt(torch.sum(normal * normal, dim=2, keepdim=True)
                        + 1e-6)
    return normal / length


def _march_tiles(ro, rd, cs, rs, qs, k, num_steps: int,
                 t_init: Optional[torch.Tensor],
                 model_axis: Optional[Axis] = None) -> torch.Tensor:
    t = (torch.zeros(ro.shape[:2] + (1,), dtype=ro.dtype, device=ro.device)
         if t_init is None else t_init.detach().reshape(ro.shape[:2] + (1,)))
    for _ in range(num_steps):
        t = torch.clamp(t + _tile_soft_min(ro + rd * t, cs, rs, qs, k,
                                           model_axis), max=T_MAX)
    return t


@torch.no_grad()
def culled_march_normals_xla(ro: torch.Tensor, rd: torch.Tensor,
                             cs: torch.Tensor, rs: torch.Tensor,
                             qs: torch.Tensor, smooth_k, num_steps: int = 40,
                             normal_eps: float = 1e-4,
                             t_init: Optional[torch.Tensor] = None,
                             model_axis: Optional[Axis] = None):
    """Plain version of K3: detached march + 6-tap normals over per-tile
    top-K tables → (t [B,T,1], normal [B,T,3]).

    ro, rd [B, T, 3]; cs [B, K, 3]; rs, qs [B, K] (qs = |c|², 1e30 in
    invalid slots). Keeps the JAX package's name so the twin is found.
    With ``model_axis`` the tables are this shard's selections and every
    step's soft-min combines the shards (two collectives a step); the
    union-table march (train/step_body.sharded_culled_kernel_march) needs
    none inside its loop.
    """
    t = _march_tiles(ro, rd, cs, rs, qs, smooth_k, num_steps, t_init,
                     model_axis)
    p_final = ro + rd * (t + _tile_soft_min(ro + rd * t, cs, rs, qs,
                                            smooth_k, model_axis))
    return t, _tile_normals(p_final, cs, rs, qs, smooth_k, eps=normal_eps,
                            model_axis=model_axis)


def render_diff_culled(
    ray_org: torch.Tensor,      # [N, 3] tile-coherent order
    ray_dir: torch.Tensor,
    centers: torch.Tensor,      # [M, 3] physical
    colors: torch.Tensor,       # [M, 3]
    radii: torch.Tensor,        # [M, 1]
    light_dir: torch.Tensor,
    ambient: torch.Tensor,
    smooth_k,
    mask: Optional[torch.Tensor] = None,
    tile: int = 512,
    k_budget: int = 256,
    num_steps: int = 40,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    normal_eps: float = 1e-4,
    t_init: Optional[torch.Tensor] = None,
    clusters: Optional[PrimitiveClusters] = None,
    cluster_budget: int = 32,
    march_normal_fn=None,
    precomputed=None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
    model_axis: Optional[Axis] = None,
) -> torch.Tensor:
    """Culled differentiable render → [N, 3]. N must divide by ``tile``.

    ``clusters`` switches selection to two-level (cluster spheres first).
    ``march_normal_fn`` (the K3 wrapper) replaces the plain tile march and
    normal taps. ``precomputed`` = (idx [B,K], valid [B,K], t [B,T,1],
    normal [B,T,3]) skips selection and the detached march: the training
    step runs them outside autograd and only the gradient-carrying tail,
    with tables re-gathered from the live parameters, runs here.
    ``model_axis``: the arguments are one shard (module docstring). K3 sees
    a whole table, so a ``march_normal_fn`` is refused then: the sharded
    step marches on the union table (train/step_body.culled_march_backend)
    and passes the result as ``precomputed``.
    """
    n = ray_org.shape[0]
    b = n // tile
    if b * tile != n:
        raise ValueError(f"N={n} not divisible by tile={tile}")
    if march_normal_fn is not None and model_axis is not None:
        raise ValueError("march_normal_fn marches a whole table; under "
                         "model_axis pass the union-table march's result "
                         "as precomputed")

    if precomputed is not None:
        idx, valid, t, normal = precomputed
        t, normal = t.detach(), normal.detach()
    else:
        cones = tile_cones(ray_org, ray_dir, tile)
        c_det, r_det = centers.detach(), radii.detach()
        if clusters is not None:
            idx, valid = select_tile_primitives_hier(
                cones, c_det, r_det, smooth_k, k_budget, clusters,
                cluster_budget, mask=mask)
        else:
            idx, valid = select_tile_primitives(cones, c_det, r_det,
                                                smooth_k, k_budget, mask=mask)
    centers_t, colors_t, radii_t, c_sq_t = gather_tile_tables(
        centers, colors, radii, idx, valid)

    ro = ray_org.reshape(b, tile, 3)
    rd = ray_dir.reshape(b, tile, 3)
    cs, rs, qs = centers_t.detach(), radii_t.detach(), c_sq_t.detach()

    if precomputed is not None:
        pass                                   # t, normal arrived detached
    elif march_normal_fn is not None:
        with torch.no_grad():
            t, normal = march_normal_fn(ro, rd, cs, rs, qs, smooth_k,
                                        num_steps=num_steps,
                                        normal_eps=normal_eps, t_init=t_init)
    else:
        with torch.no_grad():
            t = _march_tiles(ro, rd, cs, rs, qs, smooth_k, num_steps,
                             t_init, model_axis)
        normal = None

    # Gradient reattachment: one soft-min at the detached point.
    dist_last = _tile_soft_min(ro + rd * t, centers_t, radii_t, c_sq_t,
                               smooth_k, model_axis)
    t_final = t + dist_last
    p_final = ro + rd * t_final

    if normal is None:
        with torch.no_grad():
            normal = _tile_normals(p_final.detach(), cs, rs, qs, smooth_k,
                                   eps=normal_eps, model_axis=model_axis)
    # The shard's own terms at the (replicated) converged point.
    p_shard = p_final if model_axis is None else pvary(p_final, model_axis)

    # Lambertian shading.
    ld_norm = light_dir / torch.sqrt(torch.sum(light_dir * light_dir))
    diffuse = torch.clamp(torch.sum(normal * ld_norm[None, None, :], dim=2,
                                    keepdim=True), min=0.0)
    lighting = ambient + diffuse * (1.0 - ambient)

    # Softmax compositing over the tile tables.
    logits = _tile_dists(p_shard, centers_t, radii_t, c_sq_t) * (
        -softmax_sharpness)
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, MASKED_NEG))
    weights = sharded_softmax(logits, model_axis, dim=2)
    mixed = torch.bmm(weights, colors_t)
    if model_axis is not None:
        mixed = psum(mixed, model_axis)
    object_color = mixed * lighting

    dist_scene = _tile_soft_min(p_shard, centers_t, radii_t, c_sq_t,
                                smooth_k, model_axis)
    coverage = adaptive_coverage(dist_scene, t_final, mask_sharpness,
                                 mask_pixel_mult, pixel_angle,
                                 coverage_mode=coverage_mode)
    return (object_color * coverage).reshape(n, 3)

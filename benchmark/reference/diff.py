"""Differentiable renderer, the training forward model (port of
burn_raymarching_tpu/render/diff.py, single-device branch).

Gradient topology matches the reference:
  * the march runs entirely detached (``torch.no_grad``);
  * ONE reattached SDF evaluation at the converged point carries
    d t / d (centers, radii): t_final = t + sdf(p_approx);
  * normals come from a detached point with detached params;
  * Lambertian shading with learnable light_dir + ambient;
  * softmax(-10 d) color compositing (-1e30 logits on padded slots);
  * sigmoid(-15 sdf) coverage.

With ``model_axis`` (a parallel.collectives.Axis) the primitive arguments
are this rank's shard of an M-sharded table: the soft-min and the softmax
compositor combine shards with a detached max and summed exp sums, and the
colour mix is summed over the shards. The converged point and the softmax
denominator are replicated values that enter each shard's own terms, so
they pass through ``pvary``; every other use of a replicated value stays
replicated, and the output is replicated.
"""

from __future__ import annotations

from typing import Optional

import torch

from .march import march
from .sdf import (
    MASKED_NEG,
    pairwise_sphere_dists,
    scene_normal,
    scene_sdf,
)
from .collectives import (
    Axis,
    pmax,
    psum,
    pvary,
)


def adaptive_coverage(dist_scene, t_final, mask_sharpness,
                      mask_pixel_mult=0.0, pixel_angle=0.0,
                      coverage_mode: str = "sigmoid"):
    """Coverage mask: sigmoid(-mask_sharpness d) (default), or the Gaussian
    exp(-mask_sharpness d^2); with mask_pixel_mult > 0 the transition width
    becomes max(1/sharpness, mask_pixel_mult * pixel_angle * t) (t detached).
    """
    if coverage_mode == "gaussian":
        if mask_pixel_mult <= 0.0 or pixel_angle <= 0.0:
            return torch.exp(dist_scene * dist_scene * (-mask_sharpness))
        rho = t_final.detach() * pixel_angle
        w = torch.clamp(mask_pixel_mult * rho,
                        min=float(mask_sharpness) ** -0.5)
        z = dist_scene / w
        return torch.exp(-(z * z))
    if coverage_mode != "sigmoid":
        raise ValueError(f"unknown coverage_mode: {coverage_mode!r}")
    if mask_pixel_mult <= 0.0 or pixel_angle <= 0.0:
        return torch.sigmoid(dist_scene * (-mask_sharpness))
    rho = t_final.detach() * pixel_angle
    w = torch.clamp(mask_pixel_mult * rho, min=1.0 / mask_sharpness)
    return torch.sigmoid(-dist_scene / w)


def sharded_softmax(logits: torch.Tensor, model_axis: Optional[Axis] = None,
                    dim: int = 1) -> torch.Tensor:
    """Softmax over ``dim``; with ``model_axis`` over the columns of every
    shard: global max (detached), then the summed denominator."""
    if model_axis is None:
        return torch.softmax(logits, dim=dim)
    mx = pmax(torch.amax(logits, dim=dim, keepdim=True).detach(), model_axis)
    ex = torch.exp(logits - mx)
    denom = psum(torch.sum(ex, dim=dim, keepdim=True), model_axis)
    return ex / pvary(denom, model_axis)


def render_diff(
    ray_org: torch.Tensor,      # [N, 3]
    ray_dir: torch.Tensor,      # [N, 3]
    centers: torch.Tensor,      # [M, 3] physical
    colors: torch.Tensor,       # [M, 3] physical (0..1)
    radii: torch.Tensor,        # [M, 1] physical (positive)
    light_dir: torch.Tensor,    # [3] unnormalized
    ambient: torch.Tensor,      # [1] in (0, 1)
    smooth_k,
    mask: Optional[torch.Tensor] = None,   # [M] validity of padded slots
    march_fn=march,
    num_steps: int = 40,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    normal_eps: float = 1e-4,
    march_normal_fn=None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
    model_axis: Optional[Axis] = None,
) -> torch.Tensor:
    """Render a batch of rays → [N, 3] linear RGB.

    ``march_normal_fn`` (e.g. the K1 kernel) returns the detached
    (t, normal) in one call, replacing the separate march + scene_normal;
    it sees a whole table, so it is refused with ``model_axis``.
    """
    if march_normal_fn is not None and model_axis is not None:
        raise ValueError("march_normal_fn marches a whole table; it cannot "
                         "run on one model shard")
    c_det, r_det = centers.detach(), radii.detach()
    ax = {} if model_axis is None else dict(model_axis=model_axis)
    if march_normal_fn is not None:
        t, normal = march_normal_fn(ray_org, ray_dir, c_det, r_det, smooth_k,
                                    mask=mask, num_steps=num_steps,
                                    normal_eps=normal_eps)
        t, normal = t.detach(), normal.detach()
    else:
        t = march_fn(ray_org, ray_dir, c_det, r_det, smooth_k, mask=mask,
                     num_steps=num_steps, **ax)
        normal = None
    # Gradient reattachment: one SDF evaluation at the detached point.
    p_approx = ray_org + ray_dir * t
    dist_last = scene_sdf(p_approx, centers, radii, smooth_k, mask=mask, **ax)
    t_final = t + dist_last
    p_final = ray_org + ray_dir * t_final
    if normal is None:
        with torch.no_grad():
            normal = scene_normal(p_final.detach(), c_det, r_det, smooth_k,
                                  mask=mask, eps=normal_eps, **ax)
    # The shard's own terms at the (replicated) converged point.
    p_shard = p_final if model_axis is None else pvary(p_final, model_axis)

    # Lambertian shading.
    ld_norm = light_dir / torch.sqrt(torch.sum(light_dir * light_dir))
    dot = torch.sum(normal * ld_norm[None, :], dim=1, keepdim=True)   # [N,1]
    diffuse = torch.clamp(dot, min=0.0)
    lighting = ambient + diffuse * (1.0 - ambient)                     # [N,1]

    # Softmax depth compositing.
    logits = pairwise_sphere_dists(p_shard, centers, radii) * (
        -softmax_sharpness)
    if mask is not None:
        logits = torch.where(mask[None, :].bool(), logits,
                             torch.full_like(logits, MASKED_NEG))
    weights = sharded_softmax(logits, model_axis)                      # [N,M]
    mixed = weights @ colors
    if model_axis is not None:
        mixed = psum(mixed, model_axis)
    object_color = mixed * lighting

    # Coverage mask.
    dist_scene = scene_sdf(p_shard, centers, radii, smooth_k, mask=mask, **ax)
    coverage = adaptive_coverage(dist_scene, t_final, mask_sharpness,
                                 mask_pixel_mult, pixel_angle,
                                 coverage_mode=coverage_mode)
    return object_color * coverage

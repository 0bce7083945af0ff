"""Ground-truth (dataset synthesis) renderer (port of
burn_raymarching_tpu/render/gt.py).

A deliberately different forward model from the trainable renderer: fixed
light, exp weights instead of softmax, Gaussian mask instead of sigmoid.
"""

from __future__ import annotations

from typing import Optional

import torch

from .march import march_gt
from .sdf import (
    pairwise_sphere_dists,
    scene_normal,
    scene_sdf,
)


@torch.no_grad()
def render_gt(
    ray_org: torch.Tensor,   # [N, 3]
    ray_dir: torch.Tensor,   # [N, 3]
    centers: torch.Tensor,   # [M, 3]
    colors: torch.Tensor,    # [M, 3]
    radii: torch.Tensor,     # [M, 1]
    mask: Optional[torch.Tensor] = None,
    smooth_k: float = 32.0,
    num_steps: int = 40,
    light_dir: tuple = (-0.5, 0.5, -1.0),
    ambient: float = 0.1,
    weight_sharpness: float = 10.0,
    mask_sharpness: float = 10.0,
    hard_mask: bool = False,
) -> torch.Tensor:
    """Non-differentiable raymarcher → [N, 3] linear RGB.

    Light [-0.5, 0.5, -1] normalized, lighting = diffuse + 0.1, weights
    exp(-10 d) normalized by sum + 1e-5, mask exp(-10 d_scene^2).
    """
    t = march_gt(ray_org, ray_dir, centers, radii, smooth_k, mask=mask,
                 num_steps=num_steps)
    p_final = ray_org + ray_dir * t
    normal = scene_normal(p_final, centers, radii, smooth_k, mask=mask)

    ld = torch.tensor(light_dir, dtype=p_final.dtype, device=p_final.device)
    ld = ld / torch.sqrt(torch.sum(ld * ld))
    diffuse = torch.clamp(
        torch.sum(normal * ld[None, :], dim=1, keepdim=True), min=0.0)
    lighting = diffuse + ambient

    weights = torch.exp(pairwise_sphere_dists(p_final, centers, radii)
                        * (-weight_sharpness))
    if mask is not None:
        weights = weights * mask[None, :].to(weights.dtype)
    mixed_color = (weights @ colors) / (
        torch.sum(weights, dim=1, keepdim=True) + 1e-5)
    object_color = mixed_color * lighting

    dist_scene = scene_sdf(p_final, centers, radii, smooth_k, mask=mask)
    coverage = torch.exp(dist_scene * dist_scene * (-mask_sharpness))
    if hard_mask:
        coverage = (coverage > 0.5).to(coverage.dtype)
    return object_color * coverage

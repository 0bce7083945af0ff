"""Sphere-tracing march loops (port of burn_raymarching_tpu/ops/march.py).

The training march is fully detached: the reference detaches t after every
step, so no gradient flows through the iterations and gradients re-enter
through one extra SDF evaluation at the converged point. The march therefore
runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sdf import scene_sdf
from .collectives import Axis

# Cap on the march parameter t: every visible ray in a bounded scene
# converges at t < ~10; missed rays would otherwise diverge geometrically.
T_MAX = 1e4


@torch.no_grad()
def march(ray_org: torch.Tensor, ray_dir: torch.Tensor, centers: torch.Tensor,
          radii: torch.Tensor, smooth_k, mask: Optional[torch.Tensor] = None,
          num_steps: int = 40, t_init: Optional[torch.Tensor] = None,
          model_axis: Optional[Axis] = None) -> torch.Tensor:
    """Detached sphere-tracing march → final t [N, 1].

    t starts at 0 (or ``t_init`` [N, 1]), then ``num_steps`` iterations of
    t <- min(t + sdf(ro + rd t), T_MAX). With ``model_axis`` the scene is
    M-sharded and every step's soft-min combines the shards.
    """
    if t_init is None:
        t = torch.zeros((ray_org.shape[0], 1), dtype=ray_org.dtype,
                        device=ray_org.device)
    else:
        t = t_init.detach().reshape(-1, 1).to(ray_org.dtype)
    for _ in range(num_steps):
        p = ray_org + ray_dir * t
        t = torch.clamp(t + scene_sdf(p, centers, radii, smooth_k, mask=mask,
                                      model_axis=model_axis), max=T_MAX)
    return t


@torch.no_grad()
def march_gt(ray_org: torch.Tensor, ray_dir: torch.Tensor,
             centers: torch.Tensor, radii: torch.Tensor, smooth_k,
             mask: Optional[torch.Tensor] = None, num_steps: int = 40,
             model_axis: Optional[Axis] = None) -> torch.Tensor:
    """Ground-truth renderer march (never differentiated)."""
    return march(ray_org, ray_dir, centers, radii, smooth_k, mask=mask,
                 num_steps=num_steps, model_axis=model_axis)

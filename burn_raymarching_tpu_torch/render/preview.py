"""Tiled (chunked) inference rendering for previews and evaluation (port of
burn_raymarching_tpu/render/preview.py::render_tiled).

Renders in fixed-size chunks to bound the [chunk, M] working set, under
``torch.no_grad()``. With ``cull=CullRender(...)`` chunks go through
render_diff_culled (per-tile top-K tables, the K3 kernel when
``CullRender.march_normal_fn`` is set) instead of the dense march.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from burn_raymarching_tpu_torch.models.scene import (
    SceneParams,
    activate,
    scene_forward,
)
from burn_raymarching_tpu_torch.ops.march import march
from burn_raymarching_tpu_torch.render.culled import render_diff_culled
from burn_raymarching_tpu_torch.utils import morton_permutation


@dataclasses.dataclass(frozen=True)
class CullRender:
    """Culled-render options for render_tiled. ``march_normal_fn`` is the
    K3 wrapper (ops/cuda/culled_march_kernel.culled_march_normals) or None
    for the plain tile march."""

    tile: int = 512
    k_budget: int = 256
    cluster_budget: int = 32
    march_normal_fn: Any = None


@torch.no_grad()
def render_tiled(
    params: SceneParams,
    rays_o,
    rays_d,
    smooth_k: float = 32.0,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 4096,
    march_fn=None,
    march_normal_fn=None,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    cull: Optional[CullRender] = None,
    clusters=None,
    order_wh: Optional[tuple[int, int]] = None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
) -> np.ndarray:
    """Render [P, 3] rays in ``chunk``-ray pieces → np.float32 [P, 3].

    ``order_wh=(width, height)``: the rays are one raster-ordered view of
    that size; with ``cull`` they are rendered Morton-permuted (and the
    image inverse-permuted back), because raster strips make tile cones
    that span the whole scene.
    """
    if march_fn is None:
        march_fn = march
    if cull is not None and chunk % cull.tile != 0:
        raise ValueError(f"chunk ({chunk}) must divide by cull.tile "
                         f"({cull.tile})")
    dev = params.centers.device
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)
    inv = None
    if order_wh is not None and cull is not None:
        w, h = order_wh
        if w * h != rays_o.shape[0]:
            raise ValueError(f"order_wh {order_wh} != {rays_o.shape[0]} rays")
        perm = morton_permutation(w, h)
        inv = np.argsort(perm)
        perm_t = torch.as_tensor(perm, device=dev)
        rays_o, rays_d = rays_o[perm_t], rays_d[perm_t]
    n = rays_o.shape[0]
    pad = -n % chunk
    if pad:
        # Repeat the last ray, not zeros: zero directions in a mixed
        # real/pad tile would skew the cone its real rays select against.
        rays_o = torch.cat([rays_o, rays_o[-1:].expand(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d[-1:].expand(pad, 3)])
    if cull is not None:
        c, col, r, ld, amb = activate(params)
    outs = []
    for s in range(0, n + pad, chunk):
        ro = rays_o[s:s + chunk].contiguous()
        rd = rays_d[s:s + chunk].contiguous()
        if cull is not None:
            outs.append(render_diff_culled(
                ro, rd, c, col, r, ld, amb, smooth_k, mask=mask,
                tile=cull.tile, k_budget=cull.k_budget, clusters=clusters,
                cluster_budget=cull.cluster_budget,
                softmax_sharpness=softmax_sharpness,
                mask_sharpness=mask_sharpness,
                march_normal_fn=cull.march_normal_fn,
                mask_pixel_mult=mask_pixel_mult, pixel_angle=pixel_angle,
                coverage_mode=coverage_mode))
        else:
            outs.append(scene_forward(
                params, ro, rd, smooth_k, mask=mask, march_fn=march_fn,
                march_normal_fn=march_normal_fn,
                softmax_sharpness=softmax_sharpness,
                mask_sharpness=mask_sharpness,
                mask_pixel_mult=mask_pixel_mult, pixel_angle=pixel_angle,
                coverage_mode=coverage_mode))
    img = torch.cat(outs)[:n].cpu().numpy()
    return img[inv] if inv is not None else img

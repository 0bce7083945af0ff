"""Scene model: learnable raw parameters + activation mapping + forward
(port of burn_raymarching_tpu/models/scene.py).

``SceneParams`` is an ``nn.Module`` holding the five raw ``nn.Parameter``s;
``activate``, ``pad_params`` and ``raw_from_physical`` are plain functions
on tensors. Padded primitive slots carry a validity mask so M can sit in a
fixed bucket across density-control stages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from burn_raymarching_tpu_torch.ops.march import march
from burn_raymarching_tpu_torch.render.diff import render_diff

PARAM_KEYS = ("centers", "colors", "radii", "light_dir", "ambient")


class SceneParams(nn.Module):
    """Raw (pre-activation) learnable parameters.

    centers: [M, 3]   — world positions (no activation)
    colors:  [M, 3]   — logits; physical = sigmoid(colors)
    radii:   [M, 1]   — raw; physical = softplus(radii) + 0.01
    light_dir: [3]    — unnormalized direction
    ambient: [1]      — logit; physical = sigmoid(ambient)
    """

    def __init__(self, centers, colors, radii, light_dir, ambient):
        super().__init__()
        for key, value in zip(PARAM_KEYS,
                              (centers, colors, radii, light_dir, ambient)):
            t = torch.as_tensor(value, dtype=torch.float32)
            setattr(self, key, nn.Parameter(t.detach().clone()))

    @property
    def n(self) -> int:
        return self.centers.shape[0]


def activate(params: SceneParams):
    """Raw → physical: (centers, sigmoid(colors), softplus(radii) + 0.01,
    light_dir, sigmoid(ambient))."""
    return (params.centers, torch.sigmoid(params.colors),
            F.softplus(params.radii) + 0.01, params.light_dir,
            torch.sigmoid(params.ambient))


def raw_from_physical(centers, colors, radii, light_dir=(0.0, 1.0, 0.0),
                      ambient: float = 0.2,
                      device: torch.device | str = "cpu") -> SceneParams:
    """Physical → raw re-encode, the inverse of :func:`activate`; colors are
    clipped away from {0, 1} so the logit stays finite."""
    f32 = dict(dtype=torch.float32, device=device)
    colors = torch.clamp(torch.as_tensor(colors, **f32), 1e-6, 1.0 - 1e-6)
    radii = torch.as_tensor(radii, **f32)
    amb = torch.as_tensor([ambient], **f32)
    return SceneParams(
        centers=torch.as_tensor(centers, **f32),
        colors=torch.log(colors) - torch.log1p(-colors),
        radii=torch.log(torch.expm1(torch.clamp(radii - 0.01, min=1e-4))),
        light_dir=torch.as_tensor(light_dir, **f32),
        ambient=torch.log(amb) - torch.log1p(-amb),
    )


def params_from_numpy(d, device: torch.device | str = "cpu") -> SceneParams:
    """SceneParams from a dict (or npz) with the stage-checkpoint keys."""
    return SceneParams(*(torch.as_tensor(np.array(d[k], np.float32),
                                         device=device) for k in PARAM_KEYS))


def params_to_numpy(params: SceneParams) -> dict:
    """{centers, colors, radii, light_dir, ambient} → float32 numpy arrays."""
    return {k: getattr(params, k).detach().cpu().numpy().astype(np.float32)
            for k in PARAM_KEYS}


def scene_forward(
    params: SceneParams,
    ray_org: torch.Tensor,
    ray_dir: torch.Tensor,
    smooth_k,
    mask: Optional[torch.Tensor] = None,
    march_fn=march,
    march_normal_fn=None,
    num_steps: int = 40,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    normal_eps: float = 1e-4,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
    model_axis=None,
) -> torch.Tensor:
    """Full forward: activations + differentiable render → [N, 3].
    With ``model_axis`` the primitive rows of ``params`` and ``mask`` are
    this rank's shard (render_diff)."""
    centers, colors, radii, light_dir, ambient = activate(params)
    return render_diff(
        ray_org, ray_dir, centers, colors, radii, light_dir, ambient,
        smooth_k, mask=mask, march_fn=march_fn,
        march_normal_fn=march_normal_fn, num_steps=num_steps,
        softmax_sharpness=softmax_sharpness, mask_sharpness=mask_sharpness,
        normal_eps=normal_eps, mask_pixel_mult=mask_pixel_mult,
        pixel_angle=pixel_angle, coverage_mode=coverage_mode,
        model_axis=model_axis)


def init_scene_params_cloud(n: int, seed: int = 0, extent: float = 0.8,
                            radius: float = 0.03, ambient_logit: float = -1.4,
                            points=None, jitter: float = 0.02,
                            device: torch.device | str = "cpu"
                            ) -> SceneParams:
    """Random-cloud init (uniform small spheres, or ``points`` [P,3] with
    Gaussian ``jitter``); same numpy draws as the JAX package."""
    rng = np.random.default_rng(seed)
    if points is not None:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        idx = rng.integers(0, pts.shape[0], n)
        centers = (pts[idx]
                   + rng.normal(0.0, jitter, (n, 3))).astype(np.float32)
    else:
        centers = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    raw_r = float(np.log(np.expm1(max(radius - 0.01, 1e-4))))
    return SceneParams(
        centers=torch.as_tensor(centers, device=device),
        colors=torch.zeros((n, 3), device=device),
        radii=torch.full((n, 1), raw_r, device=device),
        light_dir=torch.tensor([0.0, 1.0, 0.0], device=device),
        ambient=torch.tensor([ambient_logit], device=device),
    )


def init_scene_params(n: int = 7, offset: float = 0.1,
                      ambient_logit: float = -1.4,
                      device: torch.device | str = "cpu") -> SceneParams:
    """6-directions-plus-center layout: the first 6 primitives at ±offset
    on each axis, the rest at the origin; color logits 0, raw radius 0,
    light [0,1,0], ambient logit -1.4."""
    directions = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                               [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                               [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    centers = torch.zeros((n, 3))
    k = min(n, 6)
    centers[:k] = directions[:k] * offset
    return SceneParams(
        centers=centers.to(device),
        colors=torch.zeros((n, 3), device=device),
        radii=torch.zeros((n, 1), device=device),
        light_dir=torch.tensor([0.0, 1.0, 0.0], device=device),
        ambient=torch.tensor([ambient_logit], device=device),
    )


def pad_params(params: SceneParams, m_pad: int
               ) -> tuple[SceneParams, torch.Tensor]:
    """Pad the primitive axis to ``m_pad`` zero slots → (fresh SceneParams,
    mask [m_pad] bool). Padded slots are masked out of every soft-min,
    softmax and loss term."""
    m = params.n
    if m_pad < m:
        raise ValueError(f"m_pad={m_pad} < current M={m}")
    pad = m_pad - m

    def _pad(x):
        x = x.detach()
        return torch.cat([x, x.new_zeros((pad, x.shape[1]))])

    dev = params.centers.device
    mask = torch.arange(m_pad, device=dev) < m
    return (SceneParams(_pad(params.centers), _pad(params.colors),
                        _pad(params.radii), params.light_dir.detach(),
                        params.ambient.detach()),
            mask)


def unpad_params(padded: SceneParams, n: int) -> SceneParams:
    """The first ``n`` (live) rows as fresh SceneParams."""
    return SceneParams(padded.centers.detach()[:n],
                       padded.colors.detach()[:n],
                       padded.radii.detach()[:n],
                       padded.light_dir.detach(), padded.ambient.detach())

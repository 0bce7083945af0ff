"""Pinhole look-at camera → per-pixel rays (port of
burn_raymarching_tpu/data/camera.py).

world_up = [0,1,0], forward/right/up basis, fov → half_height = tan(fov/2),
v flipped so +y is up, uv at the pixel's top-left corner.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _look_at_basis(eye: np.ndarray, target: np.ndarray):
    """Camera basis (forward, right, up), computed on the host in numpy."""
    fwd = target - eye
    n = np.linalg.norm(fwd)
    forward = fwd / n if n > 0 else np.zeros(3)
    world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, world_up)
    n = np.linalg.norm(right)
    right = right / n if n > 0 else np.zeros(3)
    up = np.cross(right, forward)
    return forward, right, up


def create_camera_rays(width: int, height: int, eye, target, fov_deg: float,
                       device: torch.device | str = "cuda"):
    """Returns (ray_org [H*W,3], ray_dir [H*W,3]) in row-major pixel order."""
    device = resolve_device(device)
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    forward, right, up = _look_at_basis(eye, target)
    half_height = np.tan(np.radians(fov_deg) / 2.0)
    half_width = (width / height) * half_height

    f32 = dict(dtype=torch.float32, device=device)
    basis = torch.as_tensor(np.stack([right, up, forward]), **f32)
    x = torch.arange(width, **f32)
    y = torch.arange(height, **f32)
    u = (x / width) * 2.0 - 1.0
    v = -((y / height) * 2.0 - 1.0)
    vv, uu = torch.meshgrid(v, u, indexing="ij")               # [H, W]
    r_scale = (uu * torch.tensor(half_width, **f32)).reshape(-1, 1)
    u_scale = (vv * torch.tensor(half_height, **f32)).reshape(-1, 1)
    d = (r_scale * basis[0][None, :] + u_scale * basis[1][None, :]
         + basis[2][None, :])
    ray_dir = d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
    ray_org = torch.as_tensor(eye, **f32)[None, :].expand_as(ray_dir)
    return ray_org.contiguous(), ray_dir

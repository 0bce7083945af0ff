"""Reconstruction-quality evaluation: PSNR of rendered views vs targets
(port of burn_raymarching_tpu/train/evaluate.py).

PSNR is computed in the 8-bit gamma-encoded domain.
"""

from __future__ import annotations

import numpy as np

from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.models.scene import SceneParams
from burn_raymarching_tpu_torch.render.preview import render_tiled


def encode_u8(img: np.ndarray) -> np.ndarray:
    """Linear → gamma-2.2 u8, matching the save pipeline."""
    return (np.clip(img, 0.0, 1.0) ** (1.0 / 2.2) * 255.0).astype(np.uint8)


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0) - 10.0 * np.log10(mse))


def evaluate_views(
    params: SceneParams,
    cameras: list[dict],
    targets: list[np.ndarray],     # per-view [H*W, 3] linear float
    width: int,
    height: int,
    smooth_k: float = 32.0,
    mask=None,
    march_fn=None,
    march_normal_fn=None,
    chunk: int = 4096,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    cull=None,
    clusters=None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
) -> dict:
    """Render every camera with the training forward model and compare →
    {"per_view": [psnr...], "mean": float, "min": float}.

    ``cull`` (render.preview.CullRender) routes rendering through the
    per-tile top-K path, in Morton pixel order."""
    dev = params.centers.device
    per_view = []
    for cam, tgt in zip(cameras, targets):
        ro, rd = create_camera_rays(width, height, cam["origin"],
                                    cam["target"], cam["fov"], device=dev)
        img = render_tiled(params, ro, rd, smooth_k=smooth_k, mask=mask,
                           chunk=chunk, march_fn=march_fn,
                           march_normal_fn=march_normal_fn,
                           softmax_sharpness=softmax_sharpness,
                           mask_sharpness=mask_sharpness,
                           cull=cull, clusters=clusters,
                           order_wh=(width, height),
                           mask_pixel_mult=mask_pixel_mult,
                           pixel_angle=pixel_angle,
                           coverage_mode=coverage_mode)
        per_view.append(psnr_u8(encode_u8(img), encode_u8(np.asarray(tgt))))
    return {"per_view": per_view, "mean": float(np.mean(per_view)),
            "min": float(np.min(per_view))}

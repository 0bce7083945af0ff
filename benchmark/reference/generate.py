"""The datasets of the benchmark's configurations: a frozen copy of the
scenes and camera rigs of the program's generator (tools/generate.py), and
``write_dataset``, its rendering loop, through this folder's copy of the
ground-truth renderer. It writes the target PNGs, cameras.json and (for the
knot) points.json, the raw files that the program and the reference both
read."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from .gt import render_gt
from .camera import create_camera_rays
from .image_io import save_array_as_image


def default_cameras(out_dir: str = "data", fov: float = 50.0,
                    radius: float = 2.5) -> list[dict]:
    """The reference's 10-camera rig."""
    cams = []
    for i in range(8):
        angle = i * (2.0 * math.pi / 8)
        cams.append({
            "file": f"{out_dir}/target_{i}.png",
            "origin": [radius * math.cos(angle), 0.5,
                       radius * math.sin(angle)],
            "target": [0.0, 0.0, 0.0],
            "fov": fov,
        })
    # Top view, z nudged to dodge the degenerate up-vector cross product.
    cams.append({"file": f"{out_dir}/target_8.png",
                 "origin": [0.0, 2.5, -0.001],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    cams.append({"file": f"{out_dir}/target_9.png",
                 "origin": [0.0, -1.5, -2.0],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    return cams


def ring_cameras(views: int, out_dir: str = "data", fov: float = 50.0,
                 radius: float = 2.5) -> list[dict]:
    """``views`` cameras over two orbit rings (y = 0.5 and y = 1.2) plus top
    and below views."""
    cams = []
    n_ring = max(views - 2, 1)
    n_low = (n_ring + 1) // 2
    for i in range(n_ring):
        low = i < n_low
        k = i if low else i - n_low
        count = n_low if low else n_ring - n_low
        angle = k * (2.0 * math.pi / max(count, 1))
        y = 0.5 if low else 1.2
        r = radius if low else radius * 0.85
        cams.append({
            "file": f"{out_dir}/target_{i}.png",
            "origin": [r * math.cos(angle), y, r * math.sin(angle)],
            "target": [0.0, 0.0, 0.0],
            "fov": fov,
        })
    cams.append({"file": f"{out_dir}/target_{n_ring}.png",
                 "origin": [0.0, 2.5, -0.001],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    cams.append({"file": f"{out_dir}/target_{n_ring + 1}.png",
                 "origin": [0.0, -1.5, -2.0],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    return cams[:views]


def knot_scene(n: int = 400, scale: float = 0.85, tube_radius: float = 0.055):
    """``n`` small spheres along a trefoil knot, hue varying along it."""
    t = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    p = np.stack([
        (2.0 + np.cos(3.0 * t)) * np.cos(2.0 * t),
        np.sin(3.0 * t),
        (2.0 + np.cos(3.0 * t)) * np.sin(2.0 * t),
    ], axis=1)
    p = p / np.abs(p).max() * scale
    hue = t / (2.0 * np.pi)
    colors = np.stack([
        0.5 + 0.5 * np.cos(2.0 * np.pi * (hue + s))
        for s in (0.0, 1.0 / 3.0, 2.0 / 3.0)
    ], axis=1)
    radii = np.full((n, 1), tube_radius)
    return (p.astype(np.float32), colors.astype(np.float32),
            radii.astype(np.float32))


def dango_scene():
    """The reference's GT scene: (centers [3,3], colors [3,3], radii [3,1])."""
    return (np.asarray([[-0.3, 0.0, 0.0], [0.0, 0.0, 0.0], [0.3, 0.0, 0.0]],
                       np.float32),
            np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                       np.float32),
            np.asarray([[0.2], [0.15], [0.2]], np.float32))


def write_dataset(out: str, spec: dict, device) -> str:
    """Render ``spec``'s dataset into ``out`` → the path of cameras.json.
    ``spec``: scene ("dango" or "knot"), size, views (0: the reference's
    10-camera rig), gt_n, gt_k, gt_sharp."""
    knot = spec["scene"] == "knot"
    c, col, r = knot_scene(spec["gt_n"]) if knot else dango_scene()
    centers, colors, radii = (torch.as_tensor(x, device=device)
                              for x in (c, col, r))
    cams = (ring_cameras(spec["views"], out) if spec["views"]
            else default_cameras(out))
    os.makedirs(out, exist_ok=True)
    size = spec["size"]
    for cam in cams:
        ro, rd = create_camera_rays(size, size, cam["origin"], cam["target"],
                                    cam["fov"], device=device)
        img = render_gt(ro, rd, centers, colors, radii,
                        smooth_k=spec["gt_k"],
                        weight_sharpness=spec["gt_sharp"],
                        mask_sharpness=spec["gt_sharp"])
        save_array_as_image(img.cpu().numpy(), size, size, cam["file"])
    path = os.path.join(out, "cameras.json")
    with open(path, "w") as f:
        json.dump(cams, f, indent=2)
    if knot:
        with open(os.path.join(out, "points.json"), "w") as f:
            json.dump({"points": c.reshape(-1).tolist()}, f)
    return path

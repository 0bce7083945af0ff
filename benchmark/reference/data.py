"""The reference's own copy of a training run's inputs: the dataset rows
built from the raw files (the program's ``build_dataset`` and
``RayDataset``, written out), the key schedule of ``Trainer.run`` and the
stage-start parameters."""

from __future__ import annotations

import json

import numpy as np
import torch

from .camera import create_camera_rays
from .dataset import compute_fg_indices
from .image_io import load_image_as_array
from .morton import multi_view_morton_permutation
from .padding import bucket_size
from .scene import init_scene_params, init_scene_params_cloud, pad_params


class Rows:
    """Every training ray as one [P, 9] (origin | direction | target)
    tensor, and the pools the sampler draws from."""

    def __init__(self, cfg, device, dtype=torch.float32):
        with open(cfg.cameras_json) as f:
            cams = json.load(f)
        ro_l, rd_l, tg_l = [], [], []
        for cam in cams:
            ro, rd = create_camera_rays(cfg.width, cfg.height, cam["origin"],
                                        cam["target"], cam["fov"],
                                        device="cpu")
            ro_l.append(ro.numpy())
            rd_l.append(rd.numpy())
            tg_l.append(load_image_as_array(cam["file"]))
        ro, rd, tg = (np.concatenate(x) for x in (ro_l, rd_l, tg_l))
        if cfg.dataset_order == "morton":
            perm = multi_view_morton_permutation(cfg.width, cfg.height,
                                                 len(cams))
            ro, rd, tg = ro[perm], rd[perm], tg[perm]
        tg = np.asarray(tg, np.float32)
        self.packed = torch.as_tensor(
            np.concatenate([ro, rd, tg], axis=1), device=device).to(dtype)
        self.n = self.packed.shape[0]
        if cfg.sample_mode == "tile":
            px = tg.sum(axis=1)
            any_fg = (px > cfg.fg_pixel_threshold).reshape(
                -1, cfg.cull_tile).any(axis=1)
            fg = np.nonzero(any_fg)[0].astype(np.int32)
            pool = np.zeros((any_fg.shape[0],), np.int32)
            pool[: fg.shape[0]] = fg
            self.fg_pool, self.n_fg = torch.as_tensor(pool, device=device), \
                int(fg.shape[0])
        else:
            pool, n_fg = compute_fg_indices(tg, cfg.fg_pixel_threshold)
            self.fg_pool, self.n_fg = torch.as_tensor(pool, device=device), \
                n_fg


def split_key(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    k = np.random.default_rng([int(x) for x in key]).integers(
        0, 2 ** 32, size=(2, 2), dtype=np.uint32)
    return k[0], k[1]


def stage_generator(seed: int, stage: int, device) -> torch.Generator:
    """The sampling generator of a run's ``stage``: ``Trainer.run`` splits
    the key [0, seed] once a stage and seeds the stage's generator with
    that stage's sub-key."""
    key = np.asarray([0, seed], np.uint32)
    for _ in range(stage + 1):
        key, sub = split_key(key)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(sub[0]) << 32) | int(sub[1]))
    return gen


def as_dtype(padded, dtype):
    """``padded`` with its parameters in ``dtype`` (in place)."""
    if dtype != torch.float32:
        with torch.no_grad():
            for p in padded.parameters():
                p.data = p.data.to(dtype)
    return padded


def stage_start_params(cfg, device, dtype=torch.float32):
    """The first stage's padded parameters and mask, from the seed."""
    if cfg.init_layout == "cloud":
        points = None
        if cfg.init_points:
            with open(cfg.init_points) as f:
                points = np.asarray(json.load(f)["points"],
                                    np.float32).reshape(-1, 3)
        params = init_scene_params_cloud(
            cfg.init_n, seed=cfg.seed, extent=cfg.init_cloud_extent,
            radius=cfg.init_cloud_radius,
            ambient_logit=cfg.init_ambient_logit, points=points,
            jitter=cfg.init_points_jitter, device=device)
    else:
        params = init_scene_params(cfg.init_n, cfg.init_offset,
                                   cfg.init_ambient_logit, device=device)
    padded, mask = pad_params(params, bucket_size(params.n))
    return as_dtype(padded, dtype), mask


def anneal_k(cfg, stage: int, step: int) -> float:
    """smooth_k of a 1-based step as the host computes it (the prefill's)."""
    progress = min((stage * cfg.steps_per_stage + step) / cfg.total_steps,
                   1.0)
    return cfg.min_smooth_k + (cfg.max_smooth_k - cfg.min_smooth_k) * progress

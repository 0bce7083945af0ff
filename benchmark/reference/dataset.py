"""Ray dataset with foreground-boosted importance sampling (port of
burn_raymarching_tpu/data/dataset.py).

A batch is floor(batch * uniform_ratio) uniform picks over all pixels plus
(batch - that) picks uniform over the fg set, with the fg-boost count capped
at |fg| when the fg set is small. Both pools sample with replacement.
Sampling uses an explicit ``torch.Generator`` on the dataset's device, and
a tensor ``uniform_ratio`` (the training step's) sizes the two pools on the
device, so no per-step host round trip is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def compute_fg_indices(targets: np.ndarray, threshold: float = 0.05):
    """Split pixel indices by target brightness → (fg_indices padded to the
    pixel count [P] int32, n_fg)."""
    sums = np.asarray(targets).reshape(-1, 3).sum(axis=1)
    fg = np.nonzero(sums > threshold)[0].astype(np.int32)
    padded = np.zeros((sums.shape[0],), np.int32)
    padded[: fg.shape[0]] = fg
    return padded, int(fg.shape[0])


def uniform_count(batch_size: int, n_fg: int, uniform_ratio):
    """Slots of a batch drawn over all pixels, the JAX package's rule:
    floor(batch · uniform_ratio) in float32, the rest from the fg pool but
    at most |fg| of them. A float ratio gives an int; a float32 tensor
    ratio an int64 tensor on its device, computed there (no host read).
    ``n_fg`` stays a host int: it is fixed by the dataset and bounds the fg
    draw."""
    if not torch.is_tensor(uniform_ratio):
        n_req = int(np.floor(np.float32(batch_size)
                             * np.float32(uniform_ratio)))
        return batch_size - (min(batch_size - n_req, n_fg) if n_fg > 0
                             else 0)
    n_req = torch.floor(uniform_ratio * float(batch_size)).to(torch.int64)
    if n_fg <= 0:
        return torch.full_like(n_req, batch_size)
    return batch_size - torch.clamp(batch_size - n_req, max=n_fg)


def sample_batch_indices(generator: torch.Generator, n_total: int,
                         fg_indices: torch.Tensor, n_fg: int,
                         batch_size: int, uniform_ratio) -> torch.Tensor:
    """Batch index sampler → [batch_size] int64 on fg_indices' device.
    ``uniform_ratio`` is a float or a float32 tensor (``uniform_count``);
    both give the same indices from the same generator."""
    dev = fg_indices.device
    n_uniform = uniform_count(batch_size, n_fg, uniform_ratio)
    uni = torch.randint(0, n_total, (batch_size,), generator=generator,
                        device=dev)
    fg_pos = torch.randint(0, max(n_fg, 1), (batch_size,),
                           generator=generator, device=dev)
    fg = fg_indices[fg_pos].long()
    slots = torch.arange(batch_size, device=dev)
    return torch.where(slots < n_uniform, uni, fg)


class RayDataset:
    """All training rays + targets, resident on ``device`` as one packed
    [P, 9] (ro | rd | target) tensor, so a batch is one row gather."""

    def __init__(self, rays_o, rays_d, targets, fg_threshold: float = 0.05,
                 device: torch.device | str = "cuda"):
        device = resolve_device(device)
        self.fg_threshold = fg_threshold
        targets = np.asarray(targets, np.float32)
        self.packed = torch.as_tensor(np.concatenate(
            [np.asarray(rays_o, np.float32), np.asarray(rays_d, np.float32),
             targets], axis=1), device=device)
        self.rays_o = self.packed[:, 0:3]
        self.rays_d = self.packed[:, 3:6]
        self.targets = self.packed[:, 6:9]
        self.num_total_pixels = int(self.packed.shape[0])
        fg_padded, n_fg = compute_fg_indices(targets, fg_threshold)
        self.fg_indices = torch.as_tensor(fg_padded, device=device)
        self.num_fg = n_fg
        self.num_bg = self.num_total_pixels - n_fg

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def sample_batch(self, generator: torch.Generator, batch_size: int,
                     uniform_ratio: float):
        """Gather one batch → (rays_o, rays_d, targets), each [B, 3]."""
        idx = sample_batch_indices(generator, self.num_total_pixels,
                                   self.fg_indices, self.num_fg, batch_size,
                                   uniform_ratio)
        return gather_batch(self.packed, idx)

    def tile_fg(self, tile: int) -> tuple[torch.Tensor, int]:
        """Tile-granular fg split for block sampling: a tile is foreground
        if ANY of its pixels is → (fg tile indices padded to the tile count
        [int32], n_fg_tiles). Needs a Morton-ordered dataset, so each run of
        ``tile`` consecutive pixels is a compact block of one view."""
        if self.num_total_pixels % tile:
            raise ValueError(f"pixels ({self.num_total_pixels}) must divide "
                             f"by tile ({tile})")
        px = self.targets.cpu().numpy().sum(axis=1)
        any_fg = (px > self.fg_threshold).reshape(-1, tile).any(axis=1)
        fg = np.nonzero(any_fg)[0].astype(np.int32)
        padded = np.zeros((any_fg.shape[0],), np.int32)
        padded[: fg.shape[0]] = fg
        return torch.as_tensor(padded, device=self.device), int(fg.shape[0])


def gather_batch(packed: torch.Tensor, idx: torch.Tensor):
    """One [B, 9] row gather → contiguous (ro, rd, target), each [B, 3]."""
    rows = packed[idx]
    return (rows[:, 0:3].contiguous(), rows[:, 3:6].contiguous(),
            rows[:, 6:9].contiguous())

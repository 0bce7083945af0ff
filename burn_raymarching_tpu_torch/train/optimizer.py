"""Adam matching the reference's Burn configuration (port of
burn_raymarching_tpu/train/optimizer.py).

weight_decay_mode="folded" (default, Burn semantics): L2 decay is added to
the gradient BEFORE the moments — ``torch.optim.Adam(weight_decay=wd)``.
"decoupled": the decay is added after the Adam direction, p -= lr (adam +
wd p) — ``torch.optim.AdamW``, whose p *= 1 - lr wd is the same update.
beta1 0.9, beta2 0.999, eps 1e-5, on the RAW parameters. The learning rate
is set per step and per parameter group (lr × lr_scale) with
``set_group_lrs``; the trainer rebuilds the optimizer at every stage, which
resets the moments.

Both run their fused implementation (``fused=True``; the same update on the
CPU and the card) with each group's learning rate a float32 tensor on the
parameters' device, which ``set_group_lrs`` overwrites in place: the step's
learning rate is a device tensor (train/step_body.device_schedule), and a
step recorded in a CUDA graph reads the rate of the step it replays. On the
card the optimizer is also ``capturable``, which torch requires of an
optimizer stepped inside a graph; the fused update keeps its step count on
the device either way, so the arithmetic is the same.
"""

from __future__ import annotations

import torch

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS, SceneParams


def make_optimizer(cfg: TrainConfig, params: SceneParams
                   ) -> torch.optim.Optimizer:
    """One parameter group per SceneParams field, named by its key, each
    with its own learning-rate tensor."""
    dev = params.centers.device
    groups = [{"params": [getattr(params, k)], "name": k,
               "lr": torch.tensor(cfg.base_lr, device=dev)}
              for k in PARAM_KEYS]
    kw = dict(lr=torch.tensor(cfg.base_lr, device=dev),
              betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
              weight_decay=cfg.weight_decay, fused=True,
              capturable=dev.type == "cuda")
    if cfg.weight_decay_mode == "decoupled":
        return torch.optim.AdamW(groups, **kw)
    if cfg.weight_decay_mode != "folded":
        raise ValueError(f"unknown weight_decay_mode "
                         f"{cfg.weight_decay_mode!r}")
    return torch.optim.Adam(groups, **kw)


def set_group_lrs(opt: torch.optim.Optimizer, lr,
                  scales: dict[str, float]) -> None:
    """lr × per-group scale into every group's learning-rate tensor, in
    place. ``lr`` is a float or a tensor on the parameters' device (no
    host read either way)."""
    for g in opt.param_groups:
        if torch.is_tensor(lr):
            g["lr"].copy_(lr * scales[g["name"]])
        else:
            g["lr"].fill_(lr * scales[g["name"]])


def anneal_for_step(cfg: TrainConfig, stage: int, step: int
                    ) -> tuple[float, float, float]:
    """(progress, smooth_k, uniform_ratio) for a 1-based step in a stage;
    progress caps at 1."""
    global_step = stage * cfg.steps_per_stage + step
    progress = min(global_step / cfg.total_steps, 1.0)
    smooth_k = cfg.min_smooth_k + (cfg.max_smooth_k - cfg.min_smooth_k
                                   ) * progress
    uniform_ratio = cfg.uniform_ratio_start - (
        (cfg.uniform_ratio_start - cfg.uniform_ratio_end) * progress)
    return progress, smooth_k, uniform_ratio

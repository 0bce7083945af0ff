"""Large-scene (config 4-5) training-step benchmark (port of
scripts/bench_large.py).

Times the whole culled training step (hierarchical selection, the detached
march, the culled tail, the 5-term loss with cluster repulsion, backward,
Adam) through the Trainer's own step closure, at M = 51,200 primitives
(800 clusters of 64), 512-ray tiles, cluster budget 32, for each per-tile
budget, far field and march variant:

  * plain  — the plain PyTorch culled march (render/culled.py), cold;
  * kernel — K3 (csrc/culled_march.cu), cold 40 steps;
  * warm   — K3 warm-started from the per-pixel t cache (16 steps).

K4 computes the repulsion in every variant, as the JAX script keeps its
repulsion kernel. Each case prints one JSON line: wall ms per step (host
clock around synchronized steps), device-busy ms per step and the device
events per step (torch.profiler: the union of the trace's kernel, copy and
memset intervals), the five kernels with the most device time, each
hand-written kernel's ms per step, the cold prefill's seconds (warm), and
the card's name and power limit.

Usage (the card):
  python -m burn_raymarching_tpu_torch.tools.bench_large [--m 51200]
      [--budgets 1024,256] [--far-fields member,monopole]
      [--variants plain,kernel,warm] [--steps 20] [--out FILE]
On the CPU (``--device cpu``) it runs the same code at whatever size it is
given, with no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from burn_raymarching_tpu_torch.tools.device_time import profile_calls


def make_dataset(n_pixels: int, side: int, device):
    """``n_pixels`` rays: one 256² view (or ``side``²) tiled, targets
    clip(|rd|, 0, 1), as the JAX script makes them."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.data.dataset import RayDataset

    ro, rd = create_camera_rays(side, side, [0.0, 0.5, -2.5], [0, 0, 0],
                                50.0)
    reps = max(1, n_pixels // (side * side))
    ro, rd = ro.numpy(), rd.numpy()
    ro, rd = np.tile(ro, (reps, 1)), np.tile(rd, (reps, 1))
    return RayDataset(ro, rd, np.clip(np.abs(rd), 0, 1), device=device)


def make_params(m: int, device):
    """M primitives uniform in the scene bound, physical radii ~0.03
    (raw N(-4, 0.3)), seeded."""
    from burn_raymarching_tpu_torch.models.scene import (
        init_scene_params,
        pad_params,
    )

    rng = np.random.default_rng(0)
    params = init_scene_params(m, device=device)
    with torch.no_grad():
        params.centers.copy_(torch.as_tensor(rng.uniform(-0.8, 0.8, (m, 3))))
        params.radii.copy_(torch.as_tensor(rng.normal(-4.0, 0.3, (m, 1))))
        params.colors.copy_(torch.as_tensor(rng.normal(0, 0.5, (m, 3))))
    return pad_params(params, m)


def bench_case(cfg, ds, padded, mask, variant: str, steps: int) -> dict:
    """One (config, variant) → its JSON record."""
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        unpad_params,
    )
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static
    from burn_raymarching_tpu_torch.train.optimizer import (
        make_optimizer,
        set_group_lrs,
    )

    tr = Trainer(cfg, ds, log=lambda s: None)
    if variant == "plain":
        tr.culled_march_normal_fn = None
    tr.warm = variant == "warm"
    tr.step_fn = tr._build_step()
    cuda = ds.device.type == "cuda"
    params, _ = pad_params(unpad_params(padded, int(mask.sum())), padded.n)
    prefill_s = 0.0
    t_cache = None
    if tr.warm:
        tr.t_cache = tr._init_t_cache()
        t0 = time.perf_counter()
        tr.prefill_t_cache(params, mask, cfg.max_smooth_k)
        if cuda:
            torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t_cache = tr.t_cache
    clusters = tr._build_cluster_table(params, mask)
    rep_static = build_repulsion_static(params.centers, clusters, mask)
    opt = make_optimizer(cfg, params)
    gen = torch.Generator(device=ds.device)
    gen.manual_seed(1)
    fg, n_fg = tr._sample_fg
    losses = []
    stage = cfg.stages - 1

    def one(i):
        loss, lr = tr.step_fn(params, gen, stage, 1 + i, mask, ds.packed, fg,
                              n_fg, t_cache=t_cache, clusters=clusters,
                              rep_static=rep_static)
        set_group_lrs(opt, lr, tr.lr_scales)
        opt.step()
        losses.append(loss)

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for i in range(3):
        one(i)
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        one(3 + i)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1000.0 / steps
    out = {"variant": variant, "m": padded.n, "budget": cfg.cull_budget,
           "tile": cfg.cull_tile, "hier": cfg.cull_hierarchical,
           "far_field": cfg.loss.repulsion_far_field,
           "batch": cfg.batch_size, "steps": steps,
           "wall_ms_per_step": wall_ms,
           "rays_per_s": cfg.batch_size / wall_ms * 1000.0,
           "prefill_s": prefill_s,
           "loss_finite": bool(torch.isfinite(torch.stack(losses)).all())}
    if cuda:
        prof = profile_calls(lambda i: one(3 + steps + i), min(steps, 10))
        out.update(prof, device_busy_share=prof["device_busy_ms_per_step"]
                   / wall_ms)
    return out


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=51200)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--pixels", type=int, default=10 * 256 * 256)
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--budgets", default="1024,256")
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--cluster-budget", dest="cluster_budget", type=int,
                    default=32)
    ap.add_argument("--no-hier", dest="hier", action="store_false")
    ap.add_argument("--warm-steps", dest="warm_steps", type=int, default=16)
    ap.add_argument("--far-fields", dest="far_fields",
                    default="member,monopole")
    ap.add_argument("--variants", default="plain,kernel,warm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    args = ap.parse_args(argv)

    from burn_raymarching_tpu_torch.config import LossConfig, TrainConfig
    from burn_raymarching_tpu_torch.tools.generate import resolve_device

    device = resolve_device(args.device)
    ds = make_dataset(args.pixels, args.side, device)
    padded, mask = make_params(args.m, device)
    where = card() if device.type == "cuda" else "cpu"
    records = []
    for budget in (int(b) for b in args.budgets.split(",")):
        for far in args.far_fields.split(","):
            cfg = TrainConfig(
                loss=LossConfig(repulsion_far_field=far),
                batch_size=args.batch, use_culling=True, cull_budget=budget,
                cull_tile=args.tile, cull_hierarchical=args.hier,
                cull_cluster_group=args.group,
                cull_cluster_budget=args.cluster_budget,
                cluster_repulsion=True, weight_decay_mode="decoupled",
                warm_start=True, warm_steps=args.warm_steps,
                checkpoint_dir=None)
            for variant in args.variants.split(","):
                rec = bench_case(cfg, ds, padded, mask, variant, args.steps)
                rec["card"] = where
                print(json.dumps(rec), flush=True)
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    main()

"""Large-scene (config 4-5) training-step benchmark (port of
scripts/bench_large.py).

Times the whole culled training step (hierarchical selection, the detached
march, the culled tail, the 5-term loss with cluster repulsion, backward,
Adam) as the Trainer runs it: ``--steps`` chained steps a call through
train/chunk.ChunkRunner (on the card each step a replay of a captured CUDA
graph), one warm-up call and the best of ``--reps``, as
the JAX script times the Trainer's jitted scan chunk. At M = 51,200
primitives (800 clusters of 64), 512-ray tiles, cluster budget 32, for each
per-tile budget, far field and march variant:

  * plain  — the plain PyTorch culled march (render/culled.py), cold;
  * kernel — K3 (csrc/culled_march.cu), cold 40 steps;
  * warm   — K3 warm-started from the per-pixel t cache (16 steps).

K4 computes the repulsion in every variant, as the JAX script keeps its
repulsion kernel. Each case prints one JSON line: the chained wall ms per
step and rays/s, the same step one step at a time
(``wall_ms_per_step_one_at_a_time``), whether the steps replayed captured
graphs (``graphs``) and ``steps_per_call``; on the card the chained
chunk's device-busy ms per step, device events and host launch calls per
step (torch.profiler: the union of the trace's kernel, copy and memset
intervals), the five kernels with the most device time and each
hand-written kernel's ms per step; the cold prefill's seconds (warm), and
the card's name and power limit.

Usage (the card):
  python -m burn_raymarching_tpu_torch.tools.bench_large [--m 51200]
      [--budgets 1024,256] [--far-fields member,monopole]
      [--variants plain,kernel,warm] [--steps 50] [--reps 3] [--out FILE]
On the CPU (``--device cpu``) it runs the same code at whatever size it is
given, one step at a time, with no device time.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from burn_raymarching_tpu_torch.tools.device_time import profile_calls

# Replays of the chained chunk that the profiler reads per case.
PROFILE_CALLS = 10


def make_dataset(n_pixels: int, side: int, device):
    """``n_pixels`` rays: one 256² view (or ``side``²) tiled, targets
    clip(|rd|, 0, 1), as the JAX script makes them."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.data.dataset import RayDataset

    ro, rd = create_camera_rays(side, side, [0.0, 0.5, -2.5], [0, 0, 0],
                                50.0, device="cpu")
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


def time_chunk(runner, batch: int, reps: int, steps: int,
               rep_seed: int = 0) -> dict:
    """A ChunkRunner's chained chunk of ``steps`` steps: one warm-up call
    (on the card the capture), then the best of ``reps`` calls, each from
    the runner's starting state (parameters, a fresh Adam state, the t
    cache) with the sampler seeded ``rep_seed + r``; reading the loss to
    the host ends each call → {rays_per_s, wall_ms_per_step, ...}. Raises
    on a non-finite loss or parameter."""
    start = runner.snapshot()
    cuda = runner.packed.device.type == "cuda"

    def call(seed: int) -> float:
        runner.restore(start)
        runner.generator.manual_seed(seed)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(1, steps)
        loss = float(runner.loss)
        elapsed = time.perf_counter() - t0
        if not math.isfinite(loss) or not all(
                bool(torch.isfinite(p).all())
                for p in runner.params.parameters()):
            raise FloatingPointError(f"non-finite loss or parameters "
                                     f"(loss {loss})")
        return elapsed / steps

    call(0)
    best = min(call(rep_seed + r) for r in range(reps))
    return {"rays_per_s": batch / best, "wall_ms_per_step": best * 1e3,
            "steps_per_call": steps, "reps": reps, "graphs": runner.graphs,
            "unroll": runner.unroll,
            "steps_run": (1 + reps) * steps + int(runner.graphs)}


def chunk_runner(cfg, step_fn, params, scales: dict, stage: int, mask,
                 packed, fg, n_fg, t_cache=None, clusters=None,
                 graphs: bool = False, idx_fn=None):
    """A ChunkRunner of ``step_fn`` on ``params`` (and a copy of
    ``t_cache``) with a fresh Adam state and a generator seeded 0, as the
    Trainer builds it (train/loop.py), ``cfg.scan_unroll`` steps a
    replay."""
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer

    gen = torch.Generator(device=packed.device)
    gen.manual_seed(0)
    return ChunkRunner(
        step_fn, params, make_optimizer(cfg, params), scales, stage, mask,
        packed, fg, n_fg, gen,
        t_cache=None if t_cache is None else t_cache.clone(),
        clusters=clusters, idx_fn=idx_fn, unroll=cfg.scan_unroll,
        graphs=graphs)


def profile_chunk(runner, calls: int) -> dict:
    """tools/device_time.profile_calls over ``calls`` replays of the
    runner's chunk (``unroll`` steps each), per training step."""
    return profile_calls(lambda i: runner.run(1, runner.unroll), calls,
                         steps_per_call=runner.unroll)


def bench_case(cfg, ds, padded, mask, variant: str, steps: int,
               reps: int = 3) -> dict:
    """One (config, variant) → its JSON record. The step runs as the
    Trainer's chained chunk (train/chunk.ChunkRunner, built as run_stage
    builds it: on the card each replay of a captured CUDA graph runs
    ``scan_unroll`` steps) of ``steps`` steps, timed by ``time_chunk``
    (scripts/bench_large.py's bench_variant: best of ``reps``); beside it
    the same step one step at a time (``wall_ms_per_step_one_at_a_time``),
    and on the card the chained chunk's device profile."""
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        unpad_params,
    )
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static
    from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree

    tr = Trainer(cfg, ds, log=lambda s: None)
    if variant == "plain":
        tr.culled_march_normal_fn = None
    tr.warm = variant == "warm"
    tr.step_fn = tr._build_step()
    cuda = ds.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n = int(mask.sum())
    params, _ = pad_params(unpad_params(padded, n), padded.n)
    prefill_s = 0.0
    if tr.warm:
        tr.t_cache = tr._init_t_cache()
        t0 = time.perf_counter()
        tr.prefill_t_cache(params, mask, cfg.max_smooth_k)
        sync()
        prefill_s = time.perf_counter() - t0
    clusters = tr._build_cluster_table(params, mask)
    stage = cfg.stages - 1
    fg, n_fg = tr._sample_fg

    def runner(graphs: bool):
        p, _ = pad_params(unpad_params(params, n), padded.n)
        run = chunk_runner(
            cfg, tr._step_for_stage(stage), p, lr_scale_tree(cfg, stage),
            stage, mask, ds.packed, fg, n_fg,
            t_cache=tr.t_cache if tr.warm else None, clusters=clusters,
            graphs=graphs)
        if cfg.cluster_repulsion:
            run.refresh_static(build_repulsion_static(p.centers, clusters,
                                                      mask))
        return run

    chained = runner(tr._replays_graphs())
    try:
        out = {"variant": variant, "m": padded.n, "budget": cfg.cull_budget,
               "tile": cfg.cull_tile, "hier": cfg.cull_hierarchical,
               "far_field": cfg.loss.repulsion_far_field,
               "warm_steps": cfg.warm_steps, "batch": cfg.batch_size,
               "steps": steps,
               **time_chunk(chained, cfg.batch_size, reps, steps,
                            rep_seed=1),
               "prefill_s": prefill_s}
        if cuda:
            prof = profile_chunk(chained, PROFILE_CALLS)
            out.update(prof, device_busy_share=prof["device_busy_ms_per_step"]
                       / out["wall_ms_per_step"])
    finally:
        chained.close()
    single = runner(False)
    single.run(1, 3)
    sync()
    t0 = time.perf_counter()
    single.run(4, steps)
    sync()
    out["wall_ms_per_step_one_at_a_time"] = ((time.perf_counter() - t0)
                                             * 1000.0 / steps)
    single.close()
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
    ap.add_argument("--steps", type=int, default=50,
                    help="chained steps per call (steps_per_call)")
    ap.add_argument("--reps", type=int, default=3)
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
    from burn_raymarching_tpu_torch.utils.device import resolve_device

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
                steps_per_call=args.steps, checkpoint_dir=None)
            for variant in args.variants.split(","):
                rec = bench_case(cfg, ds, padded, mask, variant, args.steps,
                                 args.reps)
                rec["card"] = where
                print(json.dumps(rec), flush=True)
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    main()

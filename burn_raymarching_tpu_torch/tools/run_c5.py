"""The large-scene recipe (BASELINE config 4) through the port's CLIs, with
the three quality rows of the JAX package's scripts/run_c5.py:

  ceiling  — the GT scene through the trainable forward (dense render, K1);
  init     — the prior-seeded init before training (culled render, K3);
  trained  — after train_cli's run (culled render, K3).

Defaults are config 4 as the JAX package last ran it (runs/c4_r2): a
30-view 512² knot capture (400 GT spheres, GT k 128, sharpness 40), 5,120
spheres seeded from points.json with jitter 0.02, flat top-K culling with
budget 2,048, tile sampling, cluster repulsion (member far field), warm
start, decoupled decay, lr scales 0.001,1,0.1,0.5, base LR 0.02, k 128,
sharpness 40/60, 3 × 1000 steps with merge_cell 0.04. Writes
<out>/results.json.

Usage:
  python -m burn_raymarching_tpu_torch.tools.run_c5 [--out runs/c4_torch]
      [--data DIR] [--steps 1000] [--stages 3] [--seed 0] [--device cuda]
      [--views 30 --size 512 --gt-n 400 --init-n 5120 --cull-budget 2048]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def recipe_argv(data_dir: str, out: str, *, size: int = 512,
                init_n: int = 5120, steps: int = 1000, stages: int = 3,
                cull_budget: int = 2048, seed: int = 0,
                device: str = "cuda") -> list[str]:
    """train_cli arguments of the large-scene recipe."""
    return [
        "--cameras", os.path.join(data_dir, "cameras.json"),
        "--width", str(size), "--height", str(size),
        "--stages", str(stages), "--steps", str(steps), "--seed", str(seed),
        "--init-layout", "cloud", "--init-n", str(init_n),
        "--init-points", os.path.join(data_dir, "points.json"),
        "--turbo", "--cull", str(cull_budget), "--sample-mode", "tile",
        "--cluster-repulsion", "--rep-far-field", "member",
        "--wd-mode", "decoupled", "--lr", "0.02",
        "--lr-scales", "0.001,1,0.1,0.5", "--smooth-k", "128",
        "--sharp", "40,60", "--merge-cell", "0.04",
        "--scene-out", os.path.join(out, "scene_c5.json"),
        "--steps-dir", os.path.join(out, "steps"),
        "--checkpoint-dir", "", "--device", device]


def generate_argv(data_dir: str, *, views: int = 30, size: int = 512,
                  gt_n: int = 400, device: str = "cuda") -> list[str]:
    """tools.generate arguments of the knot capture."""
    return ["--out", data_dir, "--size", str(size), "--scene", "knot",
            "--knot-n", str(gt_n), "--views", str(views), "--gt-k", "128",
            "--gt-sharp", "40", "--device", device]


def views_psnr(trainer, padded, mask, cull) -> float:
    """Mean train-view PSNR of (padded, mask) under the trainer's final
    render config: culled (``cull``, a CullRender) or dense through the
    trainer's K1 (``cull`` None)."""
    from burn_raymarching_tpu_torch.data.image_io import load_image_as_array
    from burn_raymarching_tpu_torch.data.scene_io import load_cameras
    from burn_raymarching_tpu_torch.train.evaluate import evaluate_views

    cfg = trainer.cfg
    cams = load_cameras(cfg.cameras_json)
    tgts = [load_image_as_array(c["file"]) for c in cams]
    return evaluate_views(
        padded, cams, tgts, cfg.width, cfg.height, mask=mask,
        smooth_k=cfg.max_smooth_k, march_normal_fn=trainer.march_normal_fn,
        softmax_sharpness=cfg.render.softmax_sharpness,
        mask_sharpness=cfg.render.mask_sharpness,
        mask_pixel_mult=cfg.render.mask_pixel_mult,
        pixel_angle=cfg.render.pixel_angle,
        coverage_mode=cfg.render.coverage_mode, cull=cull)["mean"]


def init_padded(trainer):
    """The trainer's stage-0 init, padded like its first stage."""
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.utils import bucket_size

    init = trainer._init_params()
    return pad_params(init, bucket_size(init.n))


def ceiling_padded(gt_n: int, device):
    """The GT knot scene as padded trainable params (the generator's fixed
    light and ambient)."""
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        raw_from_physical,
    )
    from burn_raymarching_tpu_torch.tools.generate import knot_scene
    from burn_raymarching_tpu_torch.utils import bucket_size

    c, col, r = knot_scene(gt_n)
    gt = raw_from_physical(c, col, r, light_dir=(-0.5, 0.5, -1.0),
                           ambient=0.1, device=device)
    return pad_params(gt, bucket_size(gt_n))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/c4_torch")
    p.add_argument("--data", default=None,
                   help="an existing dataset dir (default: <out>/data, "
                        "generated when absent)")
    p.add_argument("--views", type=int, default=30)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--gt-n", dest="gt_n", type=int, default=400)
    p.add_argument("--init-n", dest="init_n", type=int, default=5120)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--stages", type=int, default=3)
    p.add_argument("--cull-budget", dest="cull_budget", type=int,
                   default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from burn_raymarching_tpu_torch.tools import generate, train_cli
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    data_dir = args.data or os.path.join(args.out, "data")
    os.makedirs(args.out, exist_ok=True)
    if not os.path.exists(os.path.join(data_dir, "cameras.json")):
        generate.main(generate_argv(data_dir, views=args.views,
                                    size=args.size, gt_n=args.gt_n,
                                    device=args.device))
    argv_train = recipe_argv(
        data_dir, args.out, size=args.size, init_n=args.init_n,
        steps=args.steps, stages=args.stages, cull_budget=args.cull_budget,
        seed=args.seed, device=args.device)

    # Ceiling and init through a trainer of the same config, before
    # training; the trainer train_cli builds is used after it.
    device = generate.resolve_device(args.device)
    cfg = train_cli.build_config(train_cli.make_parser().parse_args(
        argv_train))
    probe = Trainer(cfg, build_dataset(cfg, device=device),
                    log=lambda s: None)
    results = {}
    t0 = time.perf_counter()
    results["ceiling"] = views_psnr(probe, *ceiling_padded(args.gt_n, device),
                                    cull=None)
    results["init"] = views_psnr(probe, *init_padded(probe),
                                 cull=probe._cull_render())
    results["eval_wall_s"] = time.perf_counter() - t0
    print(f"ceiling {results['ceiling']:.2f} dB, init "
          f"{results['init']:.2f} dB", flush=True)
    del probe

    t0 = time.perf_counter()
    trainer, padded, mask = train_cli.main(argv_train)
    results["train_wall_s"] = time.perf_counter() - t0
    results["trained"] = views_psnr(trainer, padded, mask,
                                    cull=trainer._cull_render())
    results.update(vars(args), n_final=int(mask.sum().item()),
                   loss_history=trainer.loss_history)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

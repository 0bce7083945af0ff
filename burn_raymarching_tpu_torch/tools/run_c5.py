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
<out>/results.json with the keys of scripts/run_c5.py, and ``events``: what
each density boundary, polish round and refine round decided
(``Trainer.events``).

After training comes the gated composition of scripts/run_c5.py:
``--polish R`` rounds, ``--refine R`` rounds (``--refine-*`` as there), then
``--alternate R`` rounds of (polish 1, refine 1); every round is kept only
if train-view PSNR improves. ``--from-scene FILE`` skips training and runs
only that composition on an exported scene; the ``init`` row is then the
loaded scene's PSNR. The JAX package's headline run (runs/c4_headline,
28.39 dB) is this recipe with ``--stages 5 --coverage gaussian --mask-sharp
40 --coverage-stages sigmoid,gaussian --polish 2 --refine 2 --alternate 2``.

Usage:
  python -m burn_raymarching_tpu_torch.tools.run_c5 [--out runs/c4_torch]
      [--data DIR] [--steps 1000] [--stages 3] [--seed 0] [--device cuda]
      [--views 30 --size 512 --gt-n 400 --init-n 5120 --cull-budget 2048]
      [--coverage gaussian --mask-sharp 40 --coverage-stages sigmoid,gaussian]
      [--split-mode residual --split-budget N] [--lr-centers-stages a,b,c]
      [--polish R] [--refine R] [--alternate R] [--from-scene scene.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def recipe_argv(data_dir: str, out: str, *, size: int = 512,
                init_n: int = 5120, steps: int = 1000, stages: int = 3,
                cull_budget: int = 2048, seed: int = 0,
                device: str = "cuda", mask_sharp: float = 60.0,
                extra: tuple = ()) -> list[str]:
    """train_cli arguments of the large-scene recipe; ``extra`` appends
    further train_cli flags (schedules, coverage family, split mode)."""
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
        "--sharp", f"40,{mask_sharp:g}", "--merge-cell", "0.04",
        "--scene-out", os.path.join(out, "scene_c5.json"),
        "--steps-dir", os.path.join(out, "steps"),
        "--checkpoint-dir", "", "--device", device, *extra]


def generate_argv(data_dir: str, *, views: int = 30, size: int = 512,
                  gt_n: int = 400, device: str = "cuda") -> list[str]:
    """tools.generate arguments of the knot capture."""
    return ["--out", data_dir, "--size", str(size), "--scene", "knot",
            "--knot-n", str(gt_n), "--views", str(views), "--gt-k", "128",
            "--gt-sharp", "40", "--device", device]


def scene_padded(path: str, device):
    """An exported scene.json as padded trainable params (the inverse of
    the export: stored radii exclude the +0.01 of the activation)."""
    from burn_raymarching_tpu_torch.data.scene_io import load_scene_json
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        raw_from_physical,
    )
    from burn_raymarching_tpu_torch.utils import bucket_size

    scene = load_scene_json(path)
    raw = raw_from_physical(
        scene["centers"], scene["colors"], scene["radii"] + 0.01,
        light_dir=scene["light_dir"],
        ambient=float(scene["ambient_intensity"][0]), device=device)
    return pad_params(raw, bucket_size(scene["num_spheres"]))


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


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add = p.add_argument
    add("--out", default="runs/c4_torch")
    add("--data", default=None,
        help="an existing dataset dir (default: <out>/data, generated when "
             "absent)")
    add("--views", type=int, default=30)
    add("--size", type=int, default=512)
    add("--gt-n", dest="gt_n", type=int, default=400)
    add("--init-n", dest="init_n", type=int, default=5120)
    add("--steps", type=int, default=1000)
    add("--stages", type=int, default=3)
    add("--cull-budget", dest="cull_budget", type=int, default=2048)
    add("--seed", type=int, default=0)
    add("--device", default="cuda")
    add("--skip-ceiling", action="store_true")
    add("--coverage", default="sigmoid", choices=["sigmoid", "gaussian"],
        help="trainable coverage family; gaussian matches the GT mask")
    add("--coverage-stages", dest="coverage_stages", default="",
        help="per-stage coverage family, comma list ending at --coverage")
    add("--mask-sharp", dest="mask_sharp", type=float, default=60.0,
        help="coverage mask sharpness (the Gaussian s with --coverage "
             "gaussian)")
    add("--split-mode", dest="split_mode", default="reference",
        choices=["reference", "residual"])
    add("--split-budget", dest="split_budget", type=int, default=0)
    add("--lr-centers-stages", dest="lr_centers_stages", default="",
        help="comma list overriding lr_scale_centers per stage")
    add("--from-scene", dest="from_scene", default="",
        help="skip training: load this exported scene json and run only "
             "--polish/--refine/--alternate on it")
    add("--polish", type=int, default=0, metavar="R")
    add("--refine", type=int, default=0, metavar="R")
    add("--refine-proposals", dest="refine_proposals", type=int, default=768)
    add("--refine-phases", dest="refine_phases", type=int, default=3)
    add("--refine-sigma-c", dest="refine_sigma_c", type=float, default=0.3)
    add("--refine-sigma-r", dest="refine_sigma_r", type=float, default=0.15)
    add("--refine-frac", dest="refine_frac", type=float, default=0.05)
    add("--refine-bias", dest="refine_bias", default="uniform",
        choices=["uniform", "residual"])
    add("--refine-colors", dest="refine_colors", type=float, default=0.0)
    add("--refine-temp", dest="refine_temp", type=float, default=0.0)
    add("--refine-fringe", dest="refine_fringe", type=float, default=1.0)
    add("--refine-light", dest="refine_light", type=int, default=0)
    add("--refine-max-budget", dest="refine_max_budget", type=int,
        default=2048, help="TrainConfig.refine_max_budget")
    add("--alternate", type=int, default=0, metavar="R",
        help="after --polish/--refine: R more rounds of (polish 1, "
             "refine 1)")
    return p


def main(argv=None) -> dict:
    import dataclasses

    args = make_parser().parse_args(argv)

    from burn_raymarching_tpu_torch.tools import generate, train_cli
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    data_dir = args.data or os.path.join(args.out, "data")
    os.makedirs(args.out, exist_ok=True)
    if not os.path.exists(os.path.join(data_dir, "cameras.json")):
        generate.main(generate_argv(data_dir, views=args.views,
                                    size=args.size, gt_n=args.gt_n,
                                    device=args.device))
    extra = ["--coverage", args.coverage, "--split-mode", args.split_mode,
             "--split-budget", str(args.split_budget)]
    for flag, value in (("--coverage-stages", args.coverage_stages),
                        ("--lr-centers-stages", args.lr_centers_stages)):
        if value:
            extra += [flag, value]
    argv_train = recipe_argv(
        data_dir, args.out, size=args.size, init_n=args.init_n,
        steps=args.steps, stages=args.stages, cull_budget=args.cull_budget,
        seed=args.seed, device=args.device, mask_sharp=args.mask_sharp,
        extra=tuple(extra))

    device = generate.resolve_device(args.device)
    cfg = dataclasses.replace(
        train_cli.build_config(train_cli.make_parser().parse_args(
            argv_train)), refine_max_budget=args.refine_max_budget)
    dataset = build_dataset(cfg, device=device)
    print(f"Total training pixels: {dataset.num_total_pixels} "
          f"(fg {dataset.num_fg})")
    trainer = Trainer(cfg, dataset)
    cams, tgts = trainer._load_views()

    def psnr(padded, mask, dense=False):
        return trainer.views_psnr(padded, mask, cams, tgts, dense=dense)

    # Every run emits the same keys (ceiling stays null with
    # --skip-ceiling).
    results = {"ceiling": None}
    t0 = time.perf_counter()
    if not args.skip_ceiling:
        results["ceiling"] = psnr(*ceiling_padded(args.gt_n, device),
                                  dense=True)
        print(f"ceiling (GT through trainable forward): "
              f"{results['ceiling']:.2f} dB", flush=True)
    if args.from_scene:
        padded, mask = scene_padded(args.from_scene, device)
        results["init"] = psnr(padded, mask)
        print(f"from-scene {args.from_scene}: {results['init']:.2f} dB",
              flush=True)
    else:
        results["init"] = psnr(*init_padded(trainer))
        print(f"prior-seeded init: {results['init']:.2f} dB", flush=True)
    results["eval_wall_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if not args.from_scene:
        padded, mask = trainer.run()
    views = dict(cameras=cams, targets=tgts, export=True)
    if args.polish:
        padded, mask = trainer.polish(padded, mask, rounds=args.polish,
                                      **views)
    refine_kw = dict(proposals=args.refine_proposals,
                     phases=args.refine_phases, sigma_c=args.refine_sigma_c,
                     sigma_r=args.refine_sigma_r, frac=args.refine_frac,
                     proposal_bias=args.refine_bias,
                     sigma_col=args.refine_colors,
                     accept_temp=args.refine_temp,
                     fringe_weight=args.refine_fringe,
                     light_proposals=args.refine_light, **views)
    if args.refine:
        padded, mask = trainer.refine_geometry(
            padded, mask, rounds=args.refine, **refine_kw)
    for _ in range(args.alternate):
        padded, mask = trainer.polish(padded, mask, rounds=1, **views)
        padded, mask = trainer.refine_geometry(padded, mask, rounds=1,
                                               **refine_kw)
    results["train_wall_s"] = round(time.perf_counter() - t0, 1)
    results["trained"] = psnr(padded, mask)
    print(f"trained: {results['trained']:.2f} dB "
          f"[{results['train_wall_s']}s]", flush=True)

    results.update(vars(args))
    results.update(
        merge_cell=cfg.density.merge_cell, lr_radii=cfg.lr_scale_radii,
        base_lr=cfg.base_lr, far_field=cfg.loss.repulsion_far_field,
        repulsion=cfg.cluster_repulsion, jitter=cfg.init_points_jitter,
        lr_centers=cfg.lr_scale_centers, prior="points",
        sample_mode=cfg.sample_mode, hier=cfg.cull_hierarchical,
        mask_px=cfg.render.mask_pixel_mult, mask_sharp_stages="",
        ss_stages="", mask_px_stages="",
        fringe_weight=cfg.loss.fringe_weight,
        fringe_threshold=cfg.loss.fringe_threshold,
        split_frac=cfg.density.split_frac,
        lr_centers_stages=list(cfg.lr_scale_centers_stages),
        n_final=int(mask.sum().item()), loss_history=trainer.loss_history,
        guard_retries=trainer.guard_retry_count, events=trainer.events)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

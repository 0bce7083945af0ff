"""Training CLI (port of burn_raymarching_tpu/tools/train_cli.py).

Takes the JAX CLI's flags and builds the same ``TrainConfig``: one run with
optional ``--polish`` and ``--refine`` rounds after it, or ``--best-of N``
seeds with the rounds on the winner. ``--device`` defaults to cuda; asking
for CUDA without a card raises.

Usage:
  python -m burn_raymarching_tpu_torch.tools.train_cli [--cameras data/cameras.json]
      [--stages 5] [--steps 700] [--batch 16384] [--resume] [--no-pallas]
      [--device cuda]

The large-scene recipe (BASELINE config 4; see tools/run_c5.py):
  ... --width 512 --height 512 --init-layout cloud --init-n 5120
      --init-points data/points.json --turbo --cull 2048 --sample-mode tile
      --cluster-repulsion --wd-mode decoupled --lr 0.02
      --lr-scales 0.001,1,0.1,0.5 --smooth-k 128 --sharp 40,60
      --stages 3 --steps 1000 --merge-cell 0.04
"""

from __future__ import annotations

import argparse


def build_config(args):
    from burn_raymarching_tpu_torch.config import (
        DensityConfig,
        LossConfig,
        RenderConfig,
        TrainConfig,
    )

    overrides = {}
    for field in ("batch_size", "width", "height", "stages", "steps_per_stage",
                  "base_lr", "seed", "init_n", "init_layout", "init_points"):
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if args.cameras:
        overrides["cameras_json"] = args.cameras
    if args.scene_out:
        overrides["scene_json"] = args.scene_out
    if args.steps_dir:
        overrides["steps_dir"] = args.steps_dir
    if args.checkpoint_dir is not None:
        overrides["checkpoint_dir"] = args.checkpoint_dir or None
    if args.no_pallas:
        overrides["use_pallas"] = False
    if args.turbo:
        overrides["warm_start"] = True
        overrides["use_fused_shade"] = True
    if args.stage_guard:
        overrides["stage_guard"] = True
        overrides["stage_guard_retries"] = args.stage_guard_retries
    if args.warm_steps:
        overrides["warm_steps"] = args.warm_steps
    if args.cull:
        overrides["use_culling"] = True
        overrides["cull_budget"] = args.cull
        overrides["dataset_order"] = "morton"
    if args.sample_mode:
        overrides["sample_mode"] = args.sample_mode
    if args.cull_hier:
        overrides["cull_hierarchical"] = True
        overrides["cull_cluster_budget"] = args.cull_hier
    if args.cluster_repulsion:
        overrides["cluster_repulsion"] = True
    if args.rep_far_field:
        overrides["loss"] = LossConfig(repulsion_far_field=args.rep_far_field)
    if args.wd_mode:
        overrides["weight_decay_mode"] = args.wd_mode
    if args.smooth_k:
        overrides["min_smooth_k"] = args.smooth_k
        overrides["max_smooth_k"] = args.smooth_k
    render_kw = {}
    if args.sharp:
        soft, mask = (float(v) for v in args.sharp.split(","))
        render_kw.update(softmax_sharpness=soft, mask_sharpness=mask)
    if args.coverage:
        render_kw["coverage_mode"] = args.coverage
    if args.mask_px:
        if args.pixel_angle <= 0.0:
            raise SystemExit(
                "--mask-px needs --pixel-angle (2*tan(fov/2)/height); "
                "without it the adaptive mask is a silent no-op")
        render_kw.update(mask_pixel_mult=args.mask_px,
                         pixel_angle=args.pixel_angle)
    if args.ss_stages or args.mask_px_stages:
        if args.pixel_angle <= 0.0:
            raise SystemExit("--ss-stages/--mask-px-stages need "
                             "--pixel-angle")
        render_kw["pixel_angle"] = args.pixel_angle
        if args.ss_stages:
            overrides["supersample_stages"] = tuple(
                int(v) for v in args.ss_stages.split(","))
        if args.mask_px_stages:
            overrides["mask_px_stages"] = tuple(
                float(v) for v in args.mask_px_stages.split(","))
    if render_kw:
        overrides["render"] = RenderConfig(**render_kw)
    density_kw = {}
    if args.merge_cell:
        density_kw["merge_cell"] = args.merge_cell
    if args.split_mode:
        density_kw.update(split_mode=args.split_mode,
                          split_budget=args.split_budget)
    if density_kw:
        overrides["density"] = DensityConfig(**density_kw)
    if args.lr_scales:
        c, col, r, light = (float(v) for v in args.lr_scales.split(","))
        overrides.update(lr_scale_centers=c, lr_scale_colors=col,
                         lr_scale_radii=r, lr_scale_light=light)
    if args.lr_centers_stages:
        overrides["lr_scale_centers_stages"] = tuple(
            float(v) for v in args.lr_centers_stages.split(","))
    if args.coverage_stages:
        overrides["coverage_mode_stages"] = tuple(
            args.coverage_stages.split(","))
    if args.mask_sharp_stages:
        overrides["mask_sharpness_stages"] = tuple(
            float(v) for v in args.mask_sharp_stages.split(","))
    return TrainConfig(**overrides)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add = p.add_argument
    add("--cameras", default="data/cameras.json")
    add("--scene-out", dest="scene_out", default="scene.json")
    add("--steps-dir", dest="steps_dir", default="steps")
    add("--checkpoint-dir", dest="checkpoint_dir", default="checkpoints")
    add("--batch", dest="batch_size", type=int, default=None)
    add("--width", type=int, default=None)
    add("--height", type=int, default=None)
    add("--stages", type=int, default=None)
    add("--steps", dest="steps_per_stage", type=int, default=None)
    add("--lr", dest="base_lr", type=float, default=None)
    add("--seed", type=int, default=None)
    add("--init-n", dest="init_n", type=int, default=None)
    add("--init-layout", dest="init_layout", default=None,
        choices=["reference", "cloud"])
    add("--init-points", dest="init_points", default=None)
    add("--resume", action="store_true")
    add("--no-pallas", action="store_true",
        help="plain PyTorch forward instead of the CUDA kernels")
    add("--device", default="cuda",
        help="torch device (default cuda; a missing card raises)")
    add("--wd-mode", dest="wd_mode", default=None,
        choices=["folded", "decoupled"])
    add("--smooth-k", dest="smooth_k", type=float, default=0.0)
    add("--sharp", default="", metavar="SOFTMAX,MASK")
    add("--lr-scales", dest="lr_scales", default="",
        metavar="CENTERS,COLORS,RADII,LIGHT")
    add("--coverage", default="", choices=["", "sigmoid", "gaussian"])
    add("--merge-cell", dest="merge_cell", type=float, default=0.0)
    add("--turbo", action="store_true",
        help="warm-start march from a per-pixel t cache")
    add("--warm-steps", dest="warm_steps", type=int, default=0)
    add("--cull", type=int, default=0, metavar="K",
        help="coherent-tile culling with a top-K budget (Morton order)")
    add("--sample-mode", dest="sample_mode", default=None,
        choices=["pixel", "tile"])
    add("--cull-hier", dest="cull_hier", type=int, default=0,
        help="two-level culling with this cluster budget")
    add("--cluster-repulsion", dest="cluster_repulsion", action="store_true")
    add("--rep-far-field", dest="rep_far_field", default="",
        choices=["", "member", "monopole"])
    add("--stage-guard", dest="stage_guard", action="store_true",
        help="in-run collapse guard: re-run a stage (fresh density-control "
             "roll and restart key) when it fails to improve train-view "
             "PSNR")
    add("--stage-guard-retries", dest="stage_guard_retries", type=int,
        default=2)
    add("--best-of", dest="best_of", type=int, default=1, metavar="N",
        help="train N seeds and export the best by train-view PSNR")
    add("--coverage-stages", dest="coverage_stages", default="")
    add("--mask-sharp-stages", dest="mask_sharp_stages", default="")
    add("--ss-stages", dest="ss_stages", default="")
    add("--mask-px-stages", dest="mask_px_stages", default="")
    add("--mask-px", dest="mask_px", type=float, default=0.0)
    add("--pixel-angle", dest="pixel_angle", type=float, default=0.0)
    add("--split-mode", dest="split_mode", default="",
        choices=["", "reference", "residual"])
    add("--split-budget", dest="split_budget", type=int, default=0)
    add("--lr-centers-stages", dest="lr_centers_stages", default="")
    add("--polish", type=int, default=0, metavar="R",
        help="R extra last-stage rounds on the final primitive set, each "
             "kept only if train-view PSNR improves")
    add("--refine", type=int, default=0, metavar="R",
        help="after polish, R PSNR-gated rounds of derivative-free "
             "geometry refinement (needs --cull)")
    add("--refine-proposals", dest="refine_proposals", type=int, default=768)
    add("--refine-frac", dest="refine_frac", type=float, default=0.05)
    add("--refine-bias", dest="refine_bias", default="uniform",
        choices=["uniform", "residual"])
    add("--refine-colors", dest="refine_colors", type=float, default=0.0)
    add("--refine-temp", dest="refine_temp", type=float, default=0.0)
    add("--refine-fringe", dest="refine_fringe", type=float, default=1.0)
    add("--refine-light", dest="refine_light", type=int, default=0)
    return p


def refine_kwargs(args) -> dict:
    """Trainer.refine_geometry arguments from the --refine-* flags."""
    return dict(proposals=args.refine_proposals, frac=args.refine_frac,
                proposal_bias=args.refine_bias, sigma_col=args.refine_colors,
                accept_temp=args.refine_temp,
                fringe_weight=args.refine_fringe,
                light_proposals=args.refine_light)


def main(argv=None):
    """Train → (trainer, final padded params, mask); with ``--best-of`` the
    winning seed's."""
    import dataclasses

    args = make_parser().parse_args(argv)
    from burn_raymarching_tpu_torch.data.scene_io import export_scene_json
    from burn_raymarching_tpu_torch.tools.generate import resolve_device
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    device = resolve_device(args.device)
    cfg = build_config(args)
    dataset = build_dataset(cfg, device=device)
    print(f"Total training pixels: {dataset.num_total_pixels}")
    print(f"Foreground pixels: {dataset.num_fg}, "
          f"Background pixels: {dataset.num_bg}")

    if args.best_of <= 1:
        trainer = Trainer(cfg, dataset)
        padded, mask = trainer.run(resume=args.resume)
        if args.polish:
            padded, mask = trainer.polish(padded, mask, rounds=args.polish)
        if args.refine:
            padded, mask = trainer.refine_geometry(
                padded, mask, rounds=args.refine, **refine_kwargs(args))
        return trainer, padded, mask

    # Best-of-N: the density-control trajectory is stochastic; train N
    # seeds and keep the best by PSNR against the training views.
    best = None
    cams = tgts = None
    for s in range(args.best_of):
        run_cfg = dataclasses.replace(
            cfg, seed=cfg.seed + s, scene_json=f"{cfg.scene_json}.seed{s}",
            steps_dir=f"{cfg.steps_dir}_seed{s}", checkpoint_dir=None)
        print(f"--- best-of run {s + 1}/{args.best_of} "
              f"(seed {run_cfg.seed}) ---")
        trainer = Trainer(run_cfg, dataset)
        padded, mask = trainer.run()
        if cams is None:
            cams, tgts = trainer._load_views()
        psnr = trainer.views_psnr(padded, mask, cams, tgts)
        print(f"    seed {run_cfg.seed}: PSNR mean {psnr:.2f}")
        if best is None or psnr > best[0]:
            best = (psnr, padded, mask, run_cfg.seed, trainer)
    psnr, padded, mask, seed, trainer = best
    if args.polish:
        padded, mask = trainer.polish(padded, mask, rounds=args.polish,
                                      export=False, cameras=cams,
                                      targets=tgts)
        psnr = trainer.views_psnr(padded, mask, cams, tgts)
        print(f"    polished: PSNR mean {psnr:.2f}")
    if args.refine:
        padded, mask = trainer.refine_geometry(
            padded, mask, rounds=args.refine, export=False, cameras=cams,
            targets=tgts, **refine_kwargs(args))
    export_scene_json(padded, cfg.scene_json, mask=mask.cpu().numpy())
    print(f"Best seed {seed}: PSNR {psnr:.2f} → {cfg.scene_json}")
    return trainer, padded, mask


if __name__ == "__main__":
    main()

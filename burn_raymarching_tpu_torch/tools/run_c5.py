"""BASELINE config 5 at its stated shape through the port (port of
scripts/run_c5.py), with the three quality rows of that script:

  ceiling  — the GT scene through the trainable forward (dense render, K1);
  init     — the prior-seeded init before training (culled render, K3);
  trained  — after the run and its gated rounds (culled render, K3).

It takes every flag of scripts/run_c5.py with the same name, default and
meaning, so that one argv drives either script, and builds the same
``TrainConfig`` (``build_config``; tests/test_torch_run_c5.py holds the
two field by field). The defaults are config 5: a 100-view 256² knot
capture (2,000 GT spheres, GT k 128, sharpness 40; the port's generator
writes it when ``--data`` has no cameras.json), 51,200 spheres seeded from
points.json (``--prior points``) or resampled along the GT curve
(``--prior dense``), flat top-K culling with budget 4,096 on 512-ray Morton
tiles, tile sampling, cluster repulsion, warm start, decoupled decay, lr
scales 0.001,1,0.1,0.5 and base LR 0.02, k 128, sharpness 40/60, 1 × 1000
steps. Config 4 (runs/c4_r2) is ``--views 30 --size 512 --gt-n 400
--init-n 5120 --cull-budget 2048 --stages 3 --merge-cell 0.04``.

After training come the gated rounds: ``--polish R``, ``--refine R``
(``--refine-*``), then ``--alternate R`` rounds of (polish 1, refine 1);
each round is kept only if train-view PSNR improves. ``--from-scene FILE``
skips training and runs only those rounds on an exported scene (the
``init`` row is then the scene's PSNR); ``--ceiling-only`` measures the
ceiling, merges it into <out>/results.json and stops. ``--distributed``
trains with DistributedTrainer, one process per card, on the mesh
``--mesh DxM`` (data x model; by default the world's size x 1, and one
that does not hold every rank of the world is refused): at 1 x 1 the JAX
script's check that the sharded trainer trains as the plain one does, at
4 x 1 config 4 data-parallel on four cards. Rank 0 writes the dataset
(when it is generated), results.json, the previews and the scene.
``--device`` (cuda by default; ``--cpu`` is ``--device cpu``) is the
port's own. The default ``--out`` is runs/c5_torch, so that the JAX
package's runs/c5 record is never overwritten.

<out>/results.json holds the JAX script's keys, each as it ran, plus
``eval_wall_s``, ``loss_history``, ``guard_retries``, ``events`` (what
each density boundary and gated round decided, ``Trainer.events``) and
how the steps ran: ``graphs`` (each step a replay of a captured CUDA
graph), and with ``--distributed`` the mesh's ``backend`` and ``mesh``
([data, model]; both null without it).

Usage:
  python -m burn_raymarching_tpu_torch.tools.run_c5 [--out runs/c5_torch]
      [--data DIR] [--steps 1000] [--stages 1] [--seed 0] [--device cuda]
  python -m torch.distributed.run --nproc-per-node 1 \\
      -m burn_raymarching_tpu_torch.tools.run_c5 --distributed ...
  torchrun --nproc-per-node 4 -m burn_raymarching_tpu_torch.tools.run_c5 \\
      --distributed --mesh 4x1 --views 30 --size 512 --gt-n 400 \\
      --init-n 5120 --cull-budget 2048 --stages 3 --merge-cell 0.04
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time


def generate_argv(data_dir: str, *, views: int = 100, size: int = 256,
                  gt_n: int = 2000, device: str = "cuda") -> list[str]:
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
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    add = p.add_argument
    add("--out", default="runs/c5_torch")
    add("--views", type=int, default=100)
    add("--size", type=int, default=256)
    add("--gt-n", dest="gt_n", type=int, default=2000)
    add("--init-n", dest="init_n", type=int, default=51200)
    add("--steps", type=int, default=1000)
    add("--stages", type=int, default=1)
    add("--merge-cell", dest="merge_cell", type=float, default=0.0,
        help="stage-boundary overlap merge (DensityConfig.merge_cell)")
    add("--lr-radii", dest="lr_radii", type=float, default=0.1)
    add("--lr-light", dest="lr_light", type=float, default=0.5)
    add("--base-lr", dest="base_lr", type=float, default=0.02)
    add("--batch", type=int, default=16384)
    add("--seed", type=int, default=0)
    add("--far-field", dest="far_field", default="member",
        choices=["member", "monopole"])
    add("--fringe-weight", dest="fringe_weight", type=float, default=1.0,
        help="loss multiplier on the dim silhouette fringe (object pixels "
             "with target sum < --fringe-threshold)")
    add("--fringe-threshold", dest="fringe_threshold", type=float,
        default=0.3)
    add("--skip-ceiling", action="store_true")
    add("--data", default=None,
        help="an existing dataset dir (default: <out>/data, generated when "
             "absent)")
    add("--no-repulsion", action="store_true")
    add("--cull-budget", dest="cull_budget", type=int, default=4096,
        help="per-tile top-K budget")
    add("--sample-mode", dest="sample_mode", default="tile",
        choices=["tile", "pixel"])
    add("--hier", action="store_true",
        help="hierarchical selection (cluster budget 32)")
    add("--jitter", type=float, default=0.02)
    add("--lr-centers", dest="lr_centers", type=float, default=0.001)
    add("--prior", default="points", choices=["points", "dense"],
        help="'points': the dataset's points.json; 'dense': the GT curve "
             "resampled at --init-n points")
    add("--mask-px", dest="mask_px", type=float, default=0.0,
        help="pixel-footprint-adaptive coverage multiplier "
             "(RenderConfig.mask_pixel_mult)")
    add("--mask-sharp", dest="mask_sharp", type=float, default=60.0,
        help="coverage mask sharpness (the Gaussian s with --coverage "
             "gaussian)")
    add("--mask-sharp-stages", dest="mask_sharp_stages", default="",
        help="per-stage mask sharpness, comma list ending at --mask-sharp")
    add("--ss-stages", dest="ss_stages", default="",
        help="per-stage pixel-footprint supersample factor, comma list "
             "ending in 1")
    add("--mask-px-stages", dest="mask_px_stages", default="",
        help="per-stage mask_pixel_mult, comma list ending at --mask-px")
    add("--coverage-stages", dest="coverage_stages", default="",
        help="per-stage coverage family, comma list ending at --coverage")
    add("--coverage", default="sigmoid", choices=["sigmoid", "gaussian"],
        help="trainable coverage family; gaussian matches the GT mask")
    add("--split-mode", dest="split_mode", default="reference",
        choices=["reference", "residual"])
    add("--split-budget", dest="split_budget", type=int, default=0)
    add("--split-frac", dest="split_frac", type=float, default=0.25)
    add("--lr-centers-stages", dest="lr_centers_stages", default="",
        help="comma list overriding lr_scale_centers per stage")
    add("--from-scene", dest="from_scene", default="",
        help="skip training: load this exported scene json and run only "
             "--polish/--refine/--alternate on it")
    add("--ceiling-only", dest="ceiling_only", action="store_true",
        help="measure the ceiling, merge it into <out>/results.json, stop")
    add("--polish", type=int, default=0, metavar="R")
    add("--refine", type=int, default=0, metavar="R")
    add("--refine-proposals", dest="refine_proposals", type=int, default=768)
    add("--refine-phases", dest="refine_phases", type=int, default=3)
    add("--refine-sigma-c", dest="refine_sigma_c", type=float, default=0.3)
    add("--refine-sigma-r", dest="refine_sigma_r", type=float, default=0.15)
    add("--refine-frac", dest="refine_frac", type=float, default=0.05)
    add("--refine-bias", dest="refine_bias", default="uniform",
        choices=["uniform", "residual"])
    add("--refine-colors", dest="refine_colors", type=float, default=0.0,
        metavar="SIGMA")
    add("--refine-temp", dest="refine_temp", type=float, default=0.0)
    add("--refine-fringe", dest="refine_fringe", type=float, default=1.0,
        metavar="W")
    add("--refine-light", dest="refine_light", type=int, default=0,
        metavar="N")
    add("--refine-max-budget", dest="refine_max_budget", type=int,
        default=2048, help="TrainConfig.refine_max_budget")
    add("--alternate", type=int, default=0, metavar="R",
        help="after --polish/--refine: R more rounds of (polish 1, "
             "refine 1)")
    add("--cpu", action="store_true", help="the same as --device cpu")
    add("--distributed", action="store_true",
        help="train with DistributedTrainer, one process per card "
             "(torch.distributed.run), on the --mesh")
    add("--mesh", default=None, metavar="DxM",
        help="with --distributed: the (data, model) mesh, e.g. 4x1 "
             "(default: the world's size x 1)")
    add("--device", default="cuda")
    return p


def world_mesh(text, world: int) -> tuple[int, int]:
    """``--mesh`` ("DxM", or None for the world's size x 1) → (data,
    model); SystemExit where the mesh does not hold the world's ranks."""
    if text is None:
        return world, 1
    try:
        data, model = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: give it as DxM, e.g. 4x1")
    if data < 1 or model < 1 or data * model != world:
        raise SystemExit(f"--mesh {text} needs {data * model} ranks, the "
                         f"world has {world}")
    return data, model


def make_trainer(args, cfg, dataset):
    """The run's trainer: the single-device Trainer, or with
    ``--distributed`` the DistributedTrainer on ``--mesh`` over the
    initialized process group."""
    from burn_raymarching_tpu_torch.train.loop import Trainer

    if not args.distributed:
        return Trainer(cfg, dataset)
    import torch.distributed as dist

    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )

    data, model = world_mesh(args.mesh, dist.get_world_size())
    return DistributedTrainer(cfg, dataset, data=data, model=model)


def _floats(text: str) -> tuple:
    return tuple(float(x) for x in text.split(",")) if text else ()


def build_config(args, data_dir: str):
    """The TrainConfig of scripts/run_c5.py:258-329 for ``args``; with
    ``--prior dense`` it first writes <out>/points_dense.json (the GT curve
    resampled at init_n points) and seeds from it."""
    from burn_raymarching_tpu_torch.config import (
        DensityConfig,
        LossConfig,
        RenderConfig,
        TrainConfig,
    )
    from burn_raymarching_tpu_torch.data.scene_io import load_cameras
    from burn_raymarching_tpu_torch.tools.generate import knot_scene

    init_points = os.path.join(data_dir, "points.json")
    if args.prior == "dense":
        import numpy as np

        dense_c, _, _ = knot_scene(args.init_n)
        init_points = os.path.join(args.out, "points_dense.json")
        with open(init_points, "w") as f:
            json.dump({"points": np.asarray(dense_c).reshape(-1).tolist()},
                      f)
    # pixel_angle derives from the dataset's own fov (all its cameras share
    # one).
    cameras_json = os.path.join(data_dir, "cameras.json")
    fov = float(load_cameras(cameras_json)[0]["fov"])
    footprint = args.mask_px > 0 or args.ss_stages or args.mask_px_stages
    return TrainConfig(
        batch_size=args.batch,
        width=args.size, height=args.size,
        stages=args.stages, steps_per_stage=args.steps,
        base_lr=args.base_lr, seed=args.seed,
        init_n=args.init_n, init_layout="cloud", init_points=init_points,
        warm_start=True, use_fused_shade=True,
        use_culling=True, cull_budget=args.cull_budget,
        dataset_order="morton", sample_mode=args.sample_mode,
        cull_hierarchical=args.hier, cull_cluster_budget=32,
        cluster_repulsion=not args.no_repulsion,
        init_points_jitter=args.jitter,
        weight_decay_mode="decoupled",
        min_smooth_k=128.0, max_smooth_k=128.0,
        lr_scale_centers=args.lr_centers, lr_scale_colors=1.0,
        lr_scale_radii=args.lr_radii, lr_scale_light=args.lr_light,
        lr_scale_centers_stages=_floats(args.lr_centers_stages),
        coverage_mode_stages=(tuple(args.coverage_stages.split(","))
                              if args.coverage_stages else ()),
        mask_sharpness_stages=_floats(args.mask_sharp_stages),
        supersample_stages=(tuple(int(x) for x in args.ss_stages.split(","))
                            if args.ss_stages else ()),
        mask_px_stages=_floats(args.mask_px_stages),
        render=RenderConfig(
            softmax_sharpness=40.0, mask_sharpness=args.mask_sharp,
            mask_pixel_mult=args.mask_px, coverage_mode=args.coverage,
            pixel_angle=(2.0 * math.tan(math.radians(fov / 2)) / args.size
                         if footprint else 0.0)),
        loss=LossConfig(repulsion_far_field=args.far_field,
                        fringe_weight=args.fringe_weight,
                        fringe_threshold=args.fringe_threshold),
        refine_max_budget=args.refine_max_budget,
        density=DensityConfig(merge_cell=args.merge_cell,
                              split_mode=args.split_mode,
                              split_budget=args.split_budget,
                              split_frac=args.split_frac),
        cameras_json=cameras_json,
        scene_json=os.path.join(args.out, "scene_c5.json"),
        steps_dir=os.path.join(args.out, "steps"),
    )


def _ceiling_only(args, ceiling: float) -> dict:
    """Merge the ceiling into an existing <out>/results.json (or write a
    fresh one), keeping the run's recorded recipe."""
    path = os.path.join(args.out, "results.json")
    prev = {}
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
    prev.update(ceiling=ceiling, ceiling_coverage=args.coverage,
                ceiling_evaluator="tools/run_c5.py --ceiling-only")
    prev.setdefault("coverage", args.coverage)
    with open(path, "w") as f:
        json.dump(prev, f, indent=1)
    print(json.dumps(prev))
    return prev


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.ceiling_only and args.skip_ceiling:
        raise SystemExit("--ceiling-only with --skip-ceiling measures "
                         "nothing; drop --skip-ceiling")

    if args.mesh and not args.distributed:
        raise SystemExit("--mesh takes --distributed")

    from burn_raymarching_tpu_torch.parallel.mesh import (
        init_distributed,
        is_host0,
    )
    from burn_raymarching_tpu_torch.tools import generate
    from burn_raymarching_tpu_torch.train.loop import build_dataset
    from burn_raymarching_tpu_torch.utils.device import resolve_device

    data_dir = args.data or os.path.join(args.out, "data")
    os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)
    if args.distributed:
        import torch.distributed as dist

        init_distributed(device)
        world_mesh(args.mesh, dist.get_world_size())
    if is_host0() and not os.path.exists(
            os.path.join(data_dir, "cameras.json")):
        print(f"--- generating {args.views}-view {args.size}px dataset ---")
        generate.main(generate_argv(data_dir, views=args.views,
                                    size=args.size, gt_n=args.gt_n,
                                    device=args.device))
    if args.distributed:
        dist.barrier()
    cfg = build_config(args, data_dir)
    dataset = build_dataset(cfg, device=device)
    trainer = make_trainer(args, cfg, dataset)
    # Every rank trains; rank 0 speaks.
    say = print if trainer._io else (lambda *a, **kw: None)
    say(f"Total training pixels: {dataset.num_total_pixels} "
        f"(fg {dataset.num_fg})")
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
        say(f"ceiling (GT through trainable forward): "
            f"{results['ceiling']:.2f} dB", flush=True)
    if args.ceiling_only:
        return _ceiling_only(args, results["ceiling"])
    if args.from_scene:
        padded, mask = scene_padded(args.from_scene, device)
        results["init"] = psnr(padded, mask)
        say(f"from-scene {args.from_scene}: {results['init']:.2f} dB",
            flush=True)
    else:
        results["init"] = psnr(*init_padded(trainer))
        say(f"prior-seeded init: {results['init']:.2f} dB", flush=True)
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
    say(f"trained ({args.steps} steps, far_field={args.far_field}): "
        f"{results['trained']:.2f} dB [{results['train_wall_s']}s]",
        flush=True)

    # The JAX script's keys, as this run had them.
    results.update({k: v for k, v in vars(args).items()
                    if k not in ("out", "data", "cpu")})
    results.update(
        repulsion=not args.no_repulsion,
        lr_centers_stages=list(cfg.lr_scale_centers_stages),
        n_final=int(mask.sum().item()), loss_history=trainer.loss_history,
        guard_retries=trainer.guard_retry_count, events=trainer.events)
    if args.distributed:
        # The trainer's one record of how its steps ran.
        (ran,) = [e for e in trainer.events if e["kind"] == "graphs"]
        results.update({k: ran[k] for k in ("graphs", "backend", "mesh")})
    else:
        results.update(graphs=trainer._replays_graphs(), backend=None,
                       mesh=None)
    if trainer._io:
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump(results, f, indent=1)
    say(json.dumps(results))
    if args.distributed:
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()

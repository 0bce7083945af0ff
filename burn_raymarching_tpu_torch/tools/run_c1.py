"""BASELINE config 1 through the port's CLIs, with its train-view PSNR: the
generator's 10-view 256² dango set, then train_cli with its defaults (the
reference init, 5 stages x 700 steps, batch 16,384, the dense kernels K1 and
K2 on a GPU). Writes <out>/results.json. The JAX package's 10-seed range
for this run is 29.87-34.60 dB (docs/PARITY.md).

Any further flags go to train_cli as they are (``--stage-guard``,
``--polish 2``, ``--best-of 3``); the stage guard's retry counts are
recorded beside the PSNR.

Usage:
  python -m burn_raymarching_tpu_torch.tools.run_c1 [--out runs/c1_torch]
      [--seed 0] [--stages 5] [--steps 700] [--size 256] [--device cuda]
      [train_cli flags]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="runs/c1_torch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stages", type=int, default=5)
    p.add_argument("--steps", type=int, default=700)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args, train_flags = p.parse_known_args(argv)

    from burn_raymarching_tpu_torch.tools import generate, train_cli

    data_dir = os.path.join(args.out, "data")
    os.makedirs(args.out, exist_ok=True)
    generate.main(["--out", data_dir, "--size", str(args.size),
                   "--device", args.device])
    t0 = time.perf_counter()
    trainer, padded, mask = train_cli.main([
        "--cameras", os.path.join(data_dir, "cameras.json"),
        "--width", str(args.size), "--height", str(args.size),
        "--stages", str(args.stages), "--steps", str(args.steps),
        "--seed", str(args.seed),
        "--scene-out", os.path.join(args.out, "scene.json"),
        "--steps-dir", os.path.join(args.out, "steps"),
        "--checkpoint-dir", "", "--device", args.device, *train_flags])
    results = {"train_wall_s": time.perf_counter() - t0,
               "psnr": trainer.views_psnr(padded, mask, dense=True),
               **vars(args), "train_flags": train_flags,
               "guard_retries": trainer.guard_retry_count,
               "guard_boundary_redos": trainer.guard_boundary_redo_count,
               "n_final": int(mask.sum().item()),
               "loss_history": trainer.loss_history,
               "events": trainer.events}
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

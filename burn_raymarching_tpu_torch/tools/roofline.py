"""A measured roofline for the dense march kernel K1 (port of
scripts/roofline.py).

The march's work per (ray, primitive) pair is one distance (a mul/add
chain and a sqrt) and one exp, followed by a row reduce and a log. Instead
of a data-sheet count, this times the same op mix as a stream on the card
and sets the fused kernel against it:

  floor  — one empty kernel (csrc/noop.cu) per iteration, SCAN (200) of
           them replayed from one captured CUDA graph: what an iteration of
           a chained launch costs at least;
  xcend  — c = exp(-18.5 sqrt(|c| + 1e-6)) + 0.5 c over [N, 128], 40 and
           16 passes an iteration, SCAN iterations chained, each carrying c
           to the next: plain PyTorch on purpose, one kernel per operation,
           so it is the unfused stream of the march's own transcendental
           ops;
  march  — K1 itself (ops/cuda/march_shade_kernel.march_shade) on the
           script's scene (100 spheres N(0, 0.3), raw radii N(-2, 0.3),
           seed 0, in 128 slots, radii softplus + 0.01, k = 18.5: the
           variant sweep's, tools/exp_march_variants.make_inputs) and its
           128² camera, 40 and 16 steps, SCAN launches chained.

The kernel runs steps + 7 field evaluations (the reattach and six normal
taps) where the stream ran ``steps`` passes, so the line per step count
reads the stream's time per pass times steps + 7 against the kernel's:
(t_x / steps)(steps + 7) / t_m above 1 means the kernel is that many times
faster per field evaluation than the unfused stream of its ops. Every time
line carries the card's name and power limit.

Usage (the card):
  python -m burn_raymarching_tpu_torch.tools.roofline [--out FILE]
On the CPU (``--device cpu --size 16``) it runs each workload once at the
size it is given and prints "not measured" for the times.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

SCAN = 200
N_SIDE = 128


def xcend_pass(c: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` serial passes of the march's exp + sqrt op mix."""
    for _ in range(passes):
        c = torch.exp(-18.5 * torch.sqrt(torch.abs(c) + 1e-6)) + c * 0.5
    return c


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=N_SIDE,
                    help="camera side: size² rays (the script's 128)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed replays of each chain; the best is kept")
    ap.add_argument("--out", default=None, help="write the results (JSON)")
    args = ap.parse_args(argv)

    from burn_raymarching_tpu_torch.ops.cuda import build
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade,
    )
    from burn_raymarching_tpu_torch.tools.bench_large import card
    from burn_raymarching_tpu_torch.tools.device_time import chained_ms
    from burn_raymarching_tpu_torch.tools.exp_march_variants import (
        K,
        make_inputs,
    )
    from burn_raymarching_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    where = card() if on_card else "cpu: not a device time"
    inp = make_inputs(args.size, dev)
    ro, rd, centers, radii, mask = (inp[key] for key in (
        "ro", "rd", "centers", "radii", "mask"))
    n, m_pad = ro.shape[0], centers.shape[0]
    out = {"card": where, "rays": n, "slots": m_pad, "scan": SCAN}

    def shown(ms) -> str:
        return f"{ms:.4f} ms" if ms is not None else "not measured"

    def timed(fn, per_graph: int = 0):
        """ms per iteration of SCAN chained calls on the card; one call on
        the CPU (the path runs, nothing is timed)."""
        if not on_card:
            fn()
            return None
        return chained_ms(fn, SCAN, per_graph=per_graph, reps=args.reps)

    floor = None
    if on_card:
        floor = timed(lambda: build.launch_noop(dev))
    out["floor_ms"] = floor
    print(f"scan floor: {shown(floor)}/iter  [{where}]", flush=True)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((n, m_pad)), dtype=torch.float32,
                        device=dev)
    stream_ms = {}
    for passes in (40, 16):
        c = x.clone()

        def one(c=c, passes=passes) -> None:
            c.copy_(xcend_pass(c, passes))

        # One iteration a graph (7 kernels a pass), replayed ``scan`` times.
        stream_ms[passes] = timed(one, per_graph=1)
        if not bool(torch.isfinite(c).all()):
            raise FloatingPointError("the exp+sqrt stream is not finite")
    out["xcend_ms"] = stream_ms
    rate = ("not measured" if stream_ms[40] is None else
            f"{n * m_pad * 40 / (stream_ms[40] / 1e3) / 1e9:.1f} "
            f"Gelem/s")
    print(f"exp+sqrt stream, {n}x{m_pad}: 40 passes "
          f"{shown(stream_ms[40])}, 16 passes {shown(stream_ms[16])} "
          f"({rate})  [{where}]", flush=True)

    march_ms = {}
    for steps in (40, 16):
        def one(steps=steps):
            t, _ = march_shade(ro, rd, centers, radii, K, mask=mask,
                               num_steps=steps)
            return t

        t = one()
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"K1 at {steps} steps is not finite")
        march_ms[steps] = timed(one)
    out["march_ms"] = march_ms
    print(f"march kernel (incl. 1 reattach + 6 normal taps): 40 steps "
          f"{shown(march_ms[40])}, 16 steps {shown(march_ms[16])}  "
          f"[{where}]", flush=True)

    out["ratio"] = {}
    for steps in (40, 16):
        t_m, t_x = march_ms[steps], stream_ms[steps]
        if t_m is None:
            out["ratio"][steps] = None
            print(f"  {steps}-step march: not measured  [{where}]",
                  flush=True)
            continue
        sol = (t_x / steps) * (steps + 7)
        ratio = sol / t_m
        out["ratio"][steps] = ratio
        rel = (f"{ratio:.2f}x FASTER than" if ratio >= 1.0 else
               f"{1 / ratio:.2f}x off")
        print(f"  {steps}-step march: {t_m:.4f} ms — {rel} the unfused "
              f"transcendental-stream bound {sol:.4f} ms  [{where}]",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

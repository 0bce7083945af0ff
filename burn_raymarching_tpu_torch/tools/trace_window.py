"""How many kernel events a traced region loses, with and without
``utils.profiling.trace``'s window margin.

Renders the viewer's train-model frame (K1 on the card) under
``profiling.trace`` ``--trials`` times for each margin and prints one JSON
line per margin: the regions whose trace lacks a kernel for some launch, the
most kernels one region lost, the earliest kernel's timestamp less the first
launch's (negative where the device clock's conversion ran early), and the
card's name and power limit.

Usage (the card):
  python -m burn_raymarching_tpu_torch.tools.trace_window
      [--scene runs/c5_headline/scene_c5.json] [--size 512]
      [--trials 30] [--margins-ms 0,10]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from burn_raymarching_tpu_torch.tools.bench_large import card


def region_events(path: str) -> dict:
    """A written trace → its kernel and launch counts, the launches with
    no kernel event, and the first kernel's offset from the first launch
    (µs)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events
                if e.get("cat", "").startswith("cuda_")
                and "LaunchKernel" in e.get("name", "")]
    seen = {e["args"].get("correlation") for e in kernels}
    lost = sum(e["args"].get("correlation") not in seen for e in launches)
    offset = None
    if kernels and launches:
        offset = (min(float(e["ts"]) for e in kernels)
                  - min(float(e["ts"]) for e in launches))
    return {"kernels": len(kernels), "launches": len(launches), "lost": lost,
            "first_kernel_minus_first_launch_us": offset}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="runs/c5_headline/scene_c5.json")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--margins-ms", default="0,10")
    args = ap.parse_args(argv)

    from burn_raymarching_tpu_torch.data.scene_io import load_scene_json
    from burn_raymarching_tpu_torch.tools.viewer_offline import render_pose
    from burn_raymarching_tpu_torch.utils import profiling
    from burn_raymarching_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    scene = load_scene_json(args.scene)

    def frame():
        return render_pose(scene, [2.5, 0.5, 0.0], [0.0, 0.0, 0.0],
                           args.size, model="train", device="cuda")

    for _ in range(3):
        frame()
    rows = []
    for margin_ms in (float(x) for x in args.margins_ms.split(",")):
        regions = []
        for _ in range(args.trials):
            with tempfile.TemporaryDirectory() as tmp:
                with profiling.trace(tmp, margin_s=margin_ms / 1000.0):
                    frame()
                regions.append(region_events(os.path.join(tmp, "trace.json")))
        offsets = [r["first_kernel_minus_first_launch_us"] for r in regions
                   if r["first_kernel_minus_first_launch_us"] is not None]
        row = {"margin_ms": margin_ms, "trials": args.trials,
               "size": args.size, "scene": args.scene,
               "launches_per_region": max(r["launches"] for r in regions),
               "regions_losing_kernels": sum(r["lost"] > 0 for r in regions),
               "most_lost_in_a_region": max(r["lost"] for r in regions),
               "min_first_kernel_minus_first_launch_us": min(offsets,
                                                             default=None),
               "card": card()}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

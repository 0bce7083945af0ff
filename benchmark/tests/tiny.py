"""Small cells for the CPU tests: the benchmark's configurations at a size
a test run holds (every mechanism of the cell kept, each size cut)."""

from __future__ import annotations

import copy
import json
import os
import types

from benchmark.harness.manifest import BENCH_DIR


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def cell(workload: str) -> types.SimpleNamespace:
    config_name, traffic_name = workload.split(".")
    config = copy.deepcopy(_load("configs", config_name))
    traffic = copy.deepcopy(_load("traffic", traffic_name))
    t = config["train"]
    if config_name == "c4_knot":
        config["dataset"].update(views=4, size=64, gt_n=60)
        t.update(width=64, height=64, init_n=96, cull_budget=32,
                 batch_size=1024, stages=2, steps_per_stage=100)
    else:
        config["dataset"].update(size=32)
        t.update(width=32, height=32, batch_size=256, stages=2,
                 steps_per_stage=100)
    if traffic["kind"] == "train":
        traffic.update(trace_from_step=0, trace_steps=100)
    else:
        traffic.update(size=64, check_full=2, check_low=2,
                       trace_from_frame=2, trace_frames=13)
        traffic["assumed"].update(drag_events=[2, 4])
    return types.SimpleNamespace(
        name=workload, chips=1, config=config, traffic=traffic,
        limits=_load("limits", workload), end_to_end=[], per_layer=[],
        run_seconds=1)

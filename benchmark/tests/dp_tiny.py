"""The data-parallel cell at a size a CPU test holds: ``c4_knot.train_dp4``
cut as ``tiny.py`` cuts ``c4_knot.train`` (4 views of 64 x 64, 96 spheres,
budget 32, 2 stages of 100 steps), with a global batch of 2,048 (one
512-ray tile a rank on the four ranks), and the planted faults that
``train_dp.run`` plants in every rank (``--plant``): each a function of a
``setattr``-like patcher."""

from __future__ import annotations

import copy
import json
import os
import types

from benchmark.harness.manifest import BENCH_DIR

WORKLOAD = "c4_knot.train_dp4"


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def cell() -> types.SimpleNamespace:
    config = copy.deepcopy(_load("configs", "c4_knot_dp4"))
    traffic = copy.deepcopy(_load("traffic", "train_dp4"))
    config["dataset"].update(views=4, size=64, gt_n=60)
    config["train"].update(width=64, height=64, init_n=96, cull_budget=32,
                           batch_size=2048, stages=2, steps_per_stage=100)
    traffic.update(trace_from_step=0, trace_steps=100, rank_timeout_s=120,
                   run_timeout_s=240)
    return types.SimpleNamespace(
        name=WORKLOAD, chips=4, config=config, traffic=traffic,
        limits=_load("limits", WORKLOAD), end_to_end=[], per_layer=[],
        run_seconds=1)


def skip_mean(patch) -> None:
    """The gradients and the loss not averaged over the data axis: each
    replica steps on its own shard's."""
    from burn_raymarching_tpu_torch.train import step_body

    patch(step_body, "mean_grads", lambda params, axis, extra: extra)


def half_batch(patch) -> None:
    """Half of each rank's batch left out, the mean taken over the rest."""
    from burn_raymarching_tpu_torch.train import step_body

    inner = step_body.compute_loss

    def half(params, out, tgt, *args, **kwargs):
        n = out.shape[0] // 2
        return inner(params, out[:n], tgt[:n], *args, **kwargs)

    patch(step_body, "compute_loss", half)

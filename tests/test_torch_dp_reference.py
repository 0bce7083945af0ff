"""Config 4 data-parallel against the benchmark's plain data-parallel
reference (benchmark/reference/dp.py), on gloo ranks on the CPU, and the
reference's own arithmetic of the shards.

* DistributedTrainer at 4 x 1 on a small culled configuration (tile
  sampling, warm start, cluster repulsion; seeded random init) against the
  reference in float64: the first steps' losses, gradients and parameters,
  every rank's draws, one density boundary and the next stage's steps, and
  the four replicas equal bit for bit.
* The shares: with equal shards, the mean of the shard gradients is the
  gradient of the mean loss over the concatenated batch; a rank's part
  left out is not.
* The benchmark's data-parallel configuration is config 4's recipe, field
  for field.
* tools/run_c5's ``--mesh`` on a world of two ranks.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch
import torch_dist

from benchmark.reference import config as ref_config
from benchmark.reference import density as ref_density
from benchmark.reference import dp
from benchmark.reference.scene import (
    init_scene_params_cloud,
    params_from_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = torch_dist.KEYS
RANKS, STEPS = 4, 3
# The config-4 cut of the sharding tests at a batch of 4 x 32 rays (two
# 16-ray tiles a rank), 8 steps a stage in chunks of 4.
CUT = dict(torch_dist.C4_CUT, seed=5)


@pytest.fixture(scope="module")
def rig():
    return torch_dist.morton_rays()


def _rows(rig):
    ro, rd, tgt = rig
    packed = torch.as_tensor(np.concatenate([ro, rd, tgt], axis=1),
                             dtype=torch.float32)
    return types.SimpleNamespace(packed=packed, n=packed.shape[0])


def _ref_cfg(**kw):
    return ref_config.TrainConfig(**{**CUT, **kw})


def _start(cfg, dtype=torch.float64):
    """The reference's stage-0 table from the seed, in ``dtype``."""
    live = init_scene_params_cloud(
        cfg.init_n, seed=cfg.seed, extent=cfg.init_cloud_extent,
        radius=cfg.init_cloud_radius, ambient_logit=cfg.init_ambient_logit,
        jitter=cfg.init_points_jitter, device="cpu")
    return dp.stage_table(live, cfg.cull_cluster_group, dtype)


def _close(a: dict, b: dict, rtol: float, atol: float) -> None:
    for k in KEYS:
        np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                   np.asarray(b[k], np.float64), rtol=rtol,
                                   atol=atol, err_msg=k)


def _steps32(cfg, rows, stage=0, table=None):
    padded, mask, clusters = table or _start(cfg, torch.float32)
    return dp.dp_steps(cfg, rows, padded, mask, clusters, stage, STEPS,
                       RANKS, "cpu", torch.float32)


def _moves(run: dict) -> dict:
    return {k: run["p3"][k].double() - run["p0"][k].double() for k in KEYS}


def _within(got: dict, ref: dict, ref32: dict) -> None:
    """``got`` (the program, float32) against ``ref`` (float64): each loss,
    gradient entry and move within 5x the float32 reference's gap + 1e-7."""
    def gap(a, b):
        return 5.0 * float((a - b).abs().max()) + 1e-7

    l64, l32 = np.asarray(ref["losses"]), np.asarray(ref32["losses"])
    assert np.abs(np.asarray(got["losses"]) - l64).max() <= gap(
        torch.as_tensor(l32), torch.as_tensor(l64)), "losses"
    for name, a, b, c in (("grad", got["grad"], ref["grad"], ref32["grad"]),
                          ("move", _moves(got), _moves(ref),
                           _moves(ref32))):
        for k in KEYS:
            x, y, z = (t[k].double() for t in (a, b, c))
            assert float((x - y).abs().max()) <= gap(z, y), (name, k)


def test_four_data_ranks_match_the_reference(tmp_path, rig):
    res = torch_dist.run_ranks(tmp_path, RANKS, torch_dist.dp_checked_run,
                               CUT, rig, str(tmp_path), STEPS)
    cfg = _ref_cfg()
    rows = _rows(rig)
    ref = dp.dp_steps(cfg, rows, *_start(cfg), 0, STEPS, RANKS, "cpu")
    got = res[0]["got"]
    # Every rank's draws, rank-major, and the stage start: exact.
    draws = [d for r in res for d in r["got"]["draws"]]
    for a, b in zip(draws, ref["draws"], strict=True):
        assert torch.equal(a.cpu(), b), "draws"
    _close(got["p0"], ref["p0"], 0, 0)
    # Float32 against float64, within 5x the reference's own float32 gap
    # (the same steps in float32) and 1e-7: the losses, the gradient and
    # each leaf's move over the steps.
    _within(got, ref, _steps32(cfg, rows))
    # The boundary: the reference's density control on rank 0's state is
    # rank 0's answer, and the next stage's steps follow from it.
    b0 = res[0]["boundary"]
    state = b0["in"]
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = copy.deepcopy(state["rng"])
    live = {k: v.float().numpy() for k, v in state["live"].items()}
    centers, colors, radii, _ = ref_density.prune_and_split(
        live["centers"], live["colors"], live["radii"],
        state["init_centers"], state["stage"], cfg.stages, rng, cfg.density)
    for k, v in (("centers", centers), ("colors", colors), ("radii", radii)):
        np.testing.assert_array_equal(b0["out"][k].numpy(), v)
    dens = params_from_numpy(
        {"centers": centers, "colors": colors, "radii": radii,
         "light_dir": live["light_dir"], "ambient": live["ambient"]},
        device="cpu")
    table = dp.stage_table(dens, cfg.cull_cluster_group, torch.float64)
    table32 = dp.stage_table(dens, cfg.cull_cluster_group)
    ref1 = dp.dp_steps(dataclasses.replace(cfg, seed=res[0]["seed"]), rows,
                       *table, state["stage"] + 1, STEPS, RANKS, "cpu")
    _close(b0["p0"], ref1["p0"], 0, 0)
    _within(b0, ref1, _steps32(dataclasses.replace(cfg, seed=res[0]["seed"]),
                               rows, state["stage"] + 1, table32))

    # The four replicas, bit for bit.
    for r in res[1:]:
        for k in KEYS:
            assert torch.equal(r["got"]["p3"][k], got["p3"][k]), k
            assert torch.equal(r["boundary"]["p3"][k], b0["p3"][k]), k


def _shard_parts(cfg, rows, padded, mask, stage, step):
    parts = dp.shards(cfg, rows, RANKS)
    batch = dp.rank_batch(cfg, RANKS)
    draws = [dp.draw_rank(cfg, dp.rank_generator(cfg.seed, stage, r, RANKS,
                                                 "cpu"), stage, step, s,
                          batch) for r, s in enumerate(parts)]
    caches = [dp.prefill_tiles(cfg, s, padded, mask, stage, [d])
              for s, d in zip(parts, draws)]
    return parts, draws, caches


def test_the_mean_of_the_shard_gradients_is_the_batch_gradient(rig):
    cfg = _ref_cfg()
    rows = _rows(rig)
    padded, mask, clusters = _start(cfg)
    parts, draws, caches = _shard_parts(cfg, rows, padded, mask, 0, 1)
    losses, _ = dp.shard_losses(cfg, padded, mask, clusters, 0, 1, parts,
                                draws, [c.clone() for c in caches])
    grads = dp.shard_grads(losses, padded)
    # The concatenated batch: every shard's draws in global ids, on the
    # whole dataset and the shards' caches laid end to end.
    idx = torch.cat([d + s.lo for d, s in zip(draws, parts)])
    whole, _ = dp.step_loss(cfg, padded, 0, 1, mask,
                            rows.packed.double(), idx, torch.cat(caches),
                            clusters)
    want = dp.shard_grads([whole], padded)[0]
    np.testing.assert_allclose(float(sum(losses).detach() / RANKS),
                               float(whole.detach()),
                               rtol=1e-12)
    _close(dp.mean_grads(grads), want, 1e-9, 1e-15)
    # One rank's part left out fails it.
    short = {k: sum(g[k] for g in grads[1:]) / RANKS for k in KEYS}
    with pytest.raises(AssertionError):
        _close(short, want, 1e-6, 1e-12)


def test_the_dp_configuration_is_config_4s_recipe():
    def load(name):
        with open(os.path.join(ROOT, "benchmark", "configs",
                               f"{name}.json")) as f:
            return json.load(f)

    one, four = load("c4_knot"), load("c4_knot_dp4")
    assert four["dataset"] == one["dataset"]
    assert four["train"] == one["train"]
    assert four["deployment"]["mesh"] == [4, 1]
    assert four["deployment"]["global_batch"] == one["train"]["batch_size"]


def test_run_c5_mesh_on_two_ranks(tmp_path, rig):
    res = torch_dist.run_ranks(tmp_path, 2, torch_dist.run_c5_mesh,
                               dict(torch_dist.C4_CUT, stages=1), rig)
    for r in res:
        assert r["meshes"] == {"None": [2, 1], "2x1": [2, 1]}
        assert sorted(r["refused"]) == ["1x1", "1x3", "4x1", "four"]
        assert "the world has 2" in r["refused"]["4x1"]

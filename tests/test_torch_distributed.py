"""DistributedTrainer (burn_raymarching_tpu_torch/parallel/distributed.py)
on gloo ranks on the CPU: the cases of tests/test_distributed.py, with the
JAX package's virtual 8-device mesh replaced by 2-4 spawned ranks
(tests/torch_dist.py), each mesh at most 4 ranks.

``test_auto_steps_per_call_targets`` is ported in
tests/test_torch_chunk_runner.py (its single-card rows against the JAX
Trainer, its sharded target of 350 through the same rule).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch_dist

from burn_raymarching_tpu_torch.data.camera import create_camera_rays

KEYS = ("centers", "colors", "radii", "light_dir", "ambient")
FULL_FEATURES = dict(
    batch_size=128, stages=2, steps_per_stage=4, use_pallas=False,
    checkpoint_dir=None, use_culling=True, cull_tile=16, cull_budget=8,
    cull_hierarchical=True, cull_cluster_group=8, cull_cluster_budget=2,
    cluster_repulsion=True, warm_start=True, warm_steps=4,
    sample_mode="tile", dataset_order="morton", init_n=12,
    init_layout="cloud", weight_decay_mode="decoupled")


@functools.cache
def tiny_dataset():
    """The JAX test's 32 × 32 rig: rays from [0, 0.5, -2.5], targets
    clip(|rd|, 0, 1)."""
    ro, rd = create_camera_rays(32, 32, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    return (ro.numpy(), rd.numpy(), np.clip(np.abs(rd.numpy()), 0, 1))


def run(tmp_path, data, model, cfg_kw, **kw):
    return torch_dist.run_ranks(
        tmp_path, data * model, torch_dist.train_distributed, data, model,
        cfg_kw, tiny_dataset(), str(tmp_path), **kw)


def assert_finite(res):
    for r in res:
        for k in KEYS:
            assert np.isfinite(r["params"][k]).all(), k


def test_is_host0_single_process():
    from burn_raymarching_tpu_torch.parallel.mesh import is_host0

    assert is_host0()


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_distributed_trainer_two_stages(tmp_path, data, model):
    res = run(tmp_path, data, model, dict(
        batch_size=64, stages=2, steps_per_stage=4, use_pallas=False,
        checkpoint_dir=None))
    assert_finite(res)
    # The bucket splits into equal model shards; every rank ends with the
    # same whole table, and only rank 0 writes.
    for r in res:
        assert r["params"]["centers"].shape[0] % model == 0
        np.testing.assert_array_equal(r["params"]["centers"],
                                      res[0]["params"]["centers"])
    assert [r["io"] for r in res] == [True] + [False] * (len(res) - 1)
    assert (tmp_path / "rank0" / "scene.json").exists()
    assert not (tmp_path / "rank1" / "scene.json").exists()


@pytest.mark.parametrize("data,model,wrappers",
                         [(2, 1, False), (1, 2, False), (1, 2, True)])
def test_distributed_full_featureset_density(tmp_path, data, model,
                                             wrappers):
    """The config-5 path on a mesh: tile culling (hierarchical), cluster
    repulsion, warm-start cache, tile-block sampling, two stages with
    density control between. With ``wrappers`` the culled step takes the
    K3 wrapper, so the model-sharded step marches on the union table."""
    res = run(tmp_path, data, model, FULL_FEATURES, kernel_wrappers=wrappers)
    assert_finite(res)
    g = FULL_FEATURES["cull_cluster_group"]
    for r in res:
        assert r["warm"]
        assert np.isfinite(r["t_cache"]).all()
        assert r["t_cache"].max() > 0.0
        assert r["params"]["centers"].shape[0] % (model * g) == 0
        # The mode the trainer decided at construction (gloo: one step
        # at a time), then the density boundary.
        assert [e["kind"] for e in r["events"]] == ["graphs", "density"]
        assert r["events"][0] == dict(kind="graphs", graphs=False,
                                      backend="gloo", mesh=[data, model])


def test_distributed_union_march_pads_the_prefill_chunk(tmp_path):
    """(1, 2) with the K3 wrapper on a 20 × 20 rig: 400 pixels are 25 tiles
    of 16, so the prefill's last 64-ray chunk holds one tile. It is padded
    to two, so that the union-table march splits it over the model ranks
    (an odd tile count is an error there, not a switch to the plain
    march). A batch of 3 tiles is refused when the trainer is built."""
    ro, rd = create_camera_rays(20, 20, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    arrays = (ro.numpy(), rd.numpy(), np.clip(np.abs(rd.numpy()), 0, 1))
    cfg = dict(FULL_FEATURES, batch_size=64, stages=1, steps_per_stage=2)
    res = torch_dist.run_ranks(
        tmp_path, 2, torch_dist.train_distributed, 1, 2, cfg, arrays,
        str(tmp_path), kernel_wrappers=True, probe_batch=48)
    assert_finite(res)
    for r in res:
        assert r["t_cache"].shape == (400,)
        assert np.isfinite(r["t_cache"]).all() and r["t_cache"].max() > 0.0
        assert "3 tiles" in r["probe_error"]


def _rows(p, m):
    # A scene is a SET of primitives (the sharded trainer Morton-sorts
    # rows at stage start): canonicalize the live rows' order.
    r = np.concatenate([p["centers"], p["colors"], p["radii"]],
                       axis=1)[m]
    return r[np.lexsort(r.T)]


def test_distributed_matches_single_device_exactly_1x1(tmp_path):
    """A 1 × 1 mesh is the single-device Trainer: the same step body, no
    data fold, no model axis, so one dense stage reproduces it bit for
    bit (the JAX package's test_distributed_matches_single_chip_exactly,
    at the mesh where the two must be identical)."""
    (r,) = run(tmp_path, 1, 1, dict(batch_size=64, stages=1,
                                    steps_per_stage=4, use_pallas=False,
                                    checkpoint_dir=None), single=True)
    for k in KEYS:
        np.testing.assert_array_equal(r["params"][k], r["single"]["params"][k])
    np.testing.assert_array_equal(r["mask"], r["single"]["mask"])
    assert r["loss_history"] == r["single"]["loss_history"]


def test_distributed_model_axis_matches_single_device(tmp_path):
    """(data=1, model=2) against the single-device Trainer, same generator:
    the shards combine with the two-pass logsumexp, so one dense stage
    reproduces the single-device params to float tolerance — the JAX
    test's (tests/test_distributed.py:95-100): rows atol 4e-3 / rtol 2e-2,
    light and ambient atol 4e-4 (reassociated sums, amplified by Adam's
    normalized steps)."""
    res = run(tmp_path, 1, 2, dict(batch_size=64, stages=1,
                                   steps_per_stage=4, use_pallas=False,
                                   checkpoint_dir=None), single=True)
    for r in res:
        one = r["single"]
        np.testing.assert_array_equal(r["mask"], one["mask"])
        np.testing.assert_allclose(_rows(r["params"], r["mask"]),
                                   _rows(one["params"], one["mask"]),
                                   atol=4e-3, rtol=2e-2)
        for k in ("light_dir", "ambient"):
            np.testing.assert_allclose(r["params"][k], one["params"][k],
                                       atol=4e-4)


def test_distributed_five_stage_density_soak(tmp_path):
    """Reference-length generation schedule (5 stages) on a 2 × 2 mesh,
    with the overlap merge and prune changing N across boundaries."""
    res = run(tmp_path, 2, 2, dict(
        batch_size=64, stages=5, steps_per_stage=3, use_pallas=False,
        checkpoint_dir=None, init_n=24, init_layout="cloud",
        density=dict(merge_cell=0.4)))
    assert_finite(res)
    live = int(res[0]["mask"].sum())
    # The 0.4-cell merge must have collapsed some of the 24-point cloud.
    assert 0 < live < 24
    assert all(int(r["mask"].sum()) == live for r in res)


def test_distributed_residual_split_grows(tmp_path):
    """Scale-aware split under the sharded trainer: the boundary scoring
    pass reads the whole dataset, and splits fire on a 2 × 2 mesh."""
    res = run(tmp_path, 2, 2, dict(
        batch_size=128, stages=2, steps_per_stage=4, use_pallas=False,
        checkpoint_dir=None, use_culling=True, cull_tile=16, cull_budget=8,
        sample_mode="tile", dataset_order="morton", init_n=12,
        init_layout="cloud", weight_decay_mode="decoupled",
        density=dict(split_mode="residual", split_budget=4)))
    assert_finite(res)
    for r in res:
        assert int(r["mask"].sum()) > 12

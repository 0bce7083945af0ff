"""Config 5 at its width (``benchmark/configs/c5_wide.json``, the cell
``c5_wide.train``) at a size a CPU test holds.

* The configuration is ``tools/run_c5.py --stages 3 --merge-cell 0.04``'s
  recipe, field for field.
* The harness's ``train`` kind on a tiny config-5-shaped cell: a knot
  capture of 20 spheres at 2 views of 32², 512 spheres seeded ~25 deep on
  its points (jitter 0.02) in 512 slots, budget 512, 2 stages of 50 steps
  with the 0.04 merge. The merge leaves ~235 spheres in 256 slots, so the
  second stage's tables are narrower than the budget (the selection's
  ``min(budget, rows)`` branch). A sound run is correct; with half of
  each batch left out, or the merge skipped, it is not.
* The program's step on the merged scene (256 slots under the budget of
  512) against the plain reference (``benchmark/reference/step.py``): the
  loss and the gradients of one step; on the card, ten captured steps
  bitwise equal to the same steps one at a time.
* On the card, the cell's stage-0 table at its width: the route of K7
  that only this configuration takes (tiles that keep more rows than
  K7's shared memory holds, ranked by rescoring the table), over every
  tile of the 100 views, and K7's tables there against the plain
  selection.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import types

import numpy as np
import pytest
import torch
from torch_parity import cuda_device, nn  # noqa: F401

from benchmark.harness import checks, train
from benchmark.reference import config as ref_config
from benchmark.reference import data as ref_data
from benchmark.reference import loss as ref_loss
from benchmark.reference import step as ref_step
from benchmark.reference.culling import build_clusters as ref_clusters
from benchmark.reference.generate import write_dataset
from benchmark.reference.scene import SceneParams as RefParams
from benchmark.tests.test_bench_checks import _half_batch, _merge_skipped
from benchmark.tests.tiny import _load
from burn_raymarching_tpu_torch import config as prog_config
from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS, SceneParams

WORKLOAD = "c5_wide.train"
SEED = 2147483647
CPU = torch.device("cpu")
# The tiny cut: every mechanism of the cell, each size cut.
TINY_DATA = dict(views=2, size=32, gt_n=20)
TINY_TRAIN = dict(width=32, height=32, init_n=512, cull_budget=512,
                  batch_size=1024, stages=2, steps_per_stage=50)


def tiny_cell() -> types.SimpleNamespace:
    config = copy.deepcopy(_load("configs", "c5_wide"))
    traffic = copy.deepcopy(_load("traffic", "train"))
    config["dataset"].update(TINY_DATA)
    config["train"].update(TINY_TRAIN)
    traffic.update(trace_from_step=0, trace_steps=50)
    return types.SimpleNamespace(
        name=WORKLOAD, chips=1, config=config, traffic=traffic,
        limits=_load("limits", WORKLOAD), end_to_end=[], per_layer=[],
        run_seconds=1)


def test_the_configuration_is_run_c5s_three_stage_recipe(tmp_path):
    """c5_wide.json's dataset is what run_c5 generates by default and its
    train section the TrainConfig of ``run_c5 --stages 3 --merge-cell
    0.04``, every field (paths and seed aside)."""
    from burn_raymarching_tpu_torch.tools import run_c5

    spec = _load("configs", "c5_wide")
    data = str(tmp_path / "data")
    write_dataset(data, dict(spec["dataset"], views=1, size=8, gt_n=20),
                  CPU)             # run_c5 reads the fov of its cameras
    args = run_c5.make_parser().parse_args(
        ["--out", str(tmp_path), "--stages", "3", "--merge-cell", "0.04"])
    want = run_c5.build_config(args, data)
    got = train.build_config(prog_config, spec["train"], data,
                             str(tmp_path), want.seed)
    paths = ("cameras_json", "data_dir", "scene_json", "steps_dir",
             "checkpoint_dir", "init_points", "metrics_jsonl")
    for f in dataclasses.fields(want):
        if f.name not in paths:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert os.path.basename(got.init_points) == os.path.basename(
        want.init_points)
    gen = run_c5.generate_argv(data)
    d = spec["dataset"]
    assert gen == run_c5.generate_argv(
        data, views=d["views"], size=d["size"], gt_n=d["gt_n"])
    assert (d["scene"], d["gt_k"], d["gt_sharp"]) == (
        "knot", float(gen[gen.index("--gt-k") + 1]),
        float(gen[gen.index("--gt-sharp") + 1]))
    assert (want.init_n, want.cull_budget, want.stages,
            want.density.merge_cell) == (51200, 4096, 3, 0.04)


def _run(tmp_path):
    cell = tiny_cell()
    res = train.run(cell, SEED, 0.5, False, str(tmp_path), CPU)
    return checks.judge(res["numbers"], cell.limits)


def test_a_sound_tiny_config5_run_is_correct(tmp_path, monkeypatch):
    """The whole cell at the tiny cut: correct, its exact numbers at 0; the
    window's first boundary merged the stacks and the next stage's tables
    are narrower than the budget."""
    from burn_raymarching_tpu_torch.train import loop

    widths = []
    inner = loop.Trainer.run_stage

    def run_stage(self, params, stage, *args, **kwargs):
        widths.append((stage, params.n, min(self.cfg.cull_budget,
                                            self._bucket(params.n))))
        return inner(self, params, stage, *args, **kwargs)

    monkeypatch.setattr(loop.Trainer, "run_stage", run_stage)
    ok, found = _run(tmp_path)
    assert ok, found
    for exact in ("init_gap", "draw_gap", "density_count_gap",
                  "density_gap"):
        assert found[exact]["value"] == 0.0
    assert "loss_rel.s1" in found
    budget = TINY_TRAIN["cull_budget"]
    assert (0, TINY_TRAIN["init_n"], budget) in widths
    after = [w for s, n, w in widths if s == 1]
    assert after and all(w < budget for w in after), widths


@pytest.mark.parametrize("fault", [_half_batch, _merge_skipped],
                         ids=["half-batch", "skip-merge"])
def test_a_planted_fault_in_the_tiny_config5_run_is_not_correct(
        fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    ok, found = _run(tmp_path)
    assert not ok, found


# --- the program's step on the merged scene ------------------------------- #

def _merged(tmp_path, device):
    """The tiny cut's trainer on ``device`` and its scene after the stage-0
    boundary's merge: the seeded stacks merged at cell 0.04 (no training:
    nothing moved, so nothing splits), padded to its bucket, below the
    budget → (trainer, spec, data dir, padded, mask)."""
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        params_from_numpy,
        params_to_numpy,
    )
    from burn_raymarching_tpu_torch.train.density import prune_and_split
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    cell = tiny_cell()
    data = str(tmp_path / "data")
    write_dataset(data, cell.config["dataset"], CPU)
    spec = dict(cell.config["train"], stages=3)
    cfg = train.build_config(prog_config, spec, data, str(tmp_path), 7)
    tr = Trainer(cfg, build_dataset(cfg, device=device), log=lambda m: None)
    init = tr._init_params()
    live = params_to_numpy(init)
    c, col, r, stats = prune_and_split(
        live["centers"], live["colors"], live["radii"], live["centers"], 0,
        cfg.stages, np.random.default_rng(0), cfg.density)
    assert stats.merged > cfg.init_n // 2, stats
    params = params_from_numpy(
        {"centers": c, "colors": col, "radii": r,
         "light_dir": live["light_dir"], "ambient": live["ambient"]},
        device=device)
    padded, mask = pad_params(params, tr._bucket(params.n))
    assert mask.numel() < cfg.cull_budget
    return tr, spec, data, padded, mask


def _stage1_runner(tr, padded, mask, graphs, seed=5):
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer
    from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree

    padded = SceneParams(*(getattr(padded, k).detach() for k in PARAM_KEYS))
    tr.prefill_t_cache(padded, mask, 128.0)
    clusters = tr._build_cluster_table(padded, mask)
    fg, n_fg = tr._sample_fg
    runner = ChunkRunner(
        tr.step_fn, padded, make_optimizer(tr.cfg, padded),
        lr_scale_tree(tr.cfg, 1), 1, mask, tr.dataset.packed, fg, n_fg,
        torch.Generator(device=tr.device).manual_seed(seed),
        t_cache=tr.t_cache, clusters=clusters, graphs=graphs)
    runner.refresh_static(build_repulsion_static(padded.centers, clusters,
                                                 mask))
    return runner


def test_the_merged_culled_step_agrees_with_the_reference(tmp_path):
    """One stage-1 step of the program (CPU: the plain one-step path) on
    the merged scene, whose 256 slots lie under the budget of 512, against
    the reference's step in float64 on the same batch, cache and cluster
    table: the loss and every leaf's gradient."""
    tr, spec, data, padded, mask = _merged(tmp_path, CPU)
    runner = _stage1_runner(tr, padded, mask, graphs=False)
    fg, n_fg = tr._sample_fg
    idx = torch.sort(torch.randperm(tr.dataset.num_total_pixels // 512,
                                    generator=torch.Generator().manual_seed(
                                        3))[:2]).values
    idx = (idx[:, None] * 512 + torch.arange(512)[None, :]).reshape(-1)
    t_cache = tr.t_cache.clone()
    loss, _ = runner.step_fn(
        runner.params, runner.generator, 1, 1, mask, tr.dataset.packed, fg,
        n_fg, idx=idx, t_cache=tr.t_cache, clusters=runner.clusters,
        rep_static=runner.rep_static)
    got = {k: getattr(runner.params, k).grad.double()
           for k in checks.LEAVES}

    cfg = train.build_config(ref_config, spec, data, str(tmp_path), 7)
    ref = ref_data.as_dtype(RefParams(*(getattr(padded, k).detach()
                                        for k in PARAM_KEYS)), torch.float64)
    clusters = ref_clusters(padded.centers.detach().numpy(),
                            mask=mask.numpy(), group=cfg.cull_cluster_group,
                            device=CPU)
    static = ref_loss.build_repulsion_static(ref.centers, clusters, mask)
    ref_l, _ = ref_step.step_loss(cfg, ref, 1, 1, mask,
                                  tr.dataset.packed.double(), idx,
                                  t_cache.double(), clusters, static)
    ref_l.backward()
    gaps = {k: float((got[k] - getattr(ref, k).grad).abs().max()
                     / getattr(ref, k).grad.abs().max())
            for k in checks.LEAVES}
    # float32 against float64: the loss 1.8e-4 apart, the worst leaf's
    # gradient 8.8e-3 of its largest entry (the cell's limits: 5e-3, 0.25).
    assert abs(float(loss) - float(ref_l)) <= 1e-3 * abs(float(ref_l))
    assert max(gaps.values()) <= 2e-2, gaps


@pytest.mark.cuda
def test_cuda_merged_stage_captured_matches_one_step_at_a_time(
        cuda_device, tmp_path):
    """Ten stage-1 steps on the merged scene (256 slots, budget 512: K7's
    tables 256 wide), replayed from a captured graph and run one step at a
    time from one state and generator: the last loss, the parameters and
    their gradients bitwise equal; K6 and K7 launched on every step."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_shade_kernel as k6
    from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7

    tr, _, _, padded, mask = _merged(tmp_path, cuda_device)
    runs = []
    for graphs in (True, False):
        runner = _stage1_runner(tr, padded, mask, graphs)
        before = k6.launch_ctail_fwd.launches, k7.launch_tile_select.launches
        runner.run(1, 10)
        torch.cuda.synchronize()
        after = k6.launch_ctail_fwd.launches, k7.launch_tile_select.launches
        assert all(b - a >= 10 for a, b in zip(before, after))
        runs.append([float(runner.loss)]
                    + [nn(p) for p in runner.params.parameters()]
                    + [nn(p.grad) for p in runner.params.parameters()])
        runner.close()
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1:], runs[1][1:]):
        np.testing.assert_array_equal(a, b)


# --- K7's rescore route at the cell's stage-0 table ------------------------ #

@pytest.mark.cuda
def test_cuda_config5_stage0_tiles_take_k7s_rescore_route(cuda_device):
    """Config 5's stage-0 table (``run_c5``'s seed-0 init: 51,200 spheres
    seeded on the 2,000-sphere knot's points, jitter 0.02, in 65,536
    rows; k = 128) against every 512-ray Morton tile of the 100 views at
    256², the tiles the stage's prefill marches and its steps draw from:
    over a tenth of them keep more than max(8,192, K) rows, the kept keys
    K7's shared memory holds at K = 4,096, so K7 ranks them by rescoring
    the table (csrc/tile_select.cu (d)). No config-4 table takes that
    route: its 8,192 rows can keep no more than 8,192. On the fullest
    tiles of four views K7's tables equal the plain selection's on K7's
    own cones (kernel_cases.k7_compare)."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7
    from burn_raymarching_tpu_torch.ops.culling import (
        CULL_MARGIN,
        cone_point_distance,
        tile_cones,
    )
    from burn_raymarching_tpu_torch.tools import kernel_cases as kc
    from burn_raymarching_tpu_torch.tools.generate import ring_cameras
    from burn_raymarching_tpu_torch.utils import morton_permutation

    spec = _load("configs", "c5_wide")
    tr, size = spec["train"], spec["dataset"]["size"]
    budget, tile, k = tr["cull_budget"], tr["cull_tile"], tr["min_smooth_k"]
    held = max(8192, budget)                  # TS_MIN_KEYS, or more for K
    _, mask, c, r = kc.knot_cloud(cuda_device, tr["init_n"],
                                  gt_n=spec["dataset"]["gt_n"])
    assert mask.numel() == 65536
    live = mask.bool()[None, :]
    perm = torch.as_tensor(morton_permutation(size, size),
                           device=cuda_device)
    cams = ring_cameras(spec["dataset"]["views"])
    rays, kept = [], []
    for cam in cams:
        ro, rd = create_camera_rays(size, size, cam["origin"],
                                    cam["target"], cam["fov"],
                                    device=cuda_device)
        ro, rd = ro[perm], rd[perm]
        cones = tile_cones(ro, rd, tile)
        score = cone_point_distance(cones, c) - r.reshape(1, -1)
        keep = (score <= CULL_MARGIN / k + cones.origin_spread[:, None]) & live
        kept.append(keep.sum(dim=1))
        rays.append((ro, rd))
    kept = torch.stack(kept)                                 # [views, tiles]
    over = kept > held
    print(f"tiles {kept.numel()}: kept mean {kept.float().mean():.0f}, "
          f"max {int(kept.max())}; over K {int((kept > budget).sum())}, "
          f"over {held} {int(over.sum())}, empty {int((kept == 0).sum())}")
    assert over.float().mean() > 0.1
    for v in torch.argsort(over.sum(dim=1), descending=True)[:4].tolist():
        ro, rd = rays[v]
        out = k7.launch_tile_select(ro, rd, tile, c, r, k, budget, mask,
                                    with_cones=True)
        torch.cuda.synchronize()
        cmp = kc.k7_compare(ro, rd, c, r, k, budget, mask, out)
        assert cmp["bad"] == 0, (v, cmp)
        assert cmp["cone_max_abs_gap"] <= kc.K7_CONE_TOL, (v, cmp)
        assert bool(out[1][over[v]].all()), v       # full tables there

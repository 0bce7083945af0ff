"""The in-run stage guard (TrainConfig.stage_guard): the port's
Trainer._run_guarded / _guarded_boundary against the JAX package's.

Both trainers are driven by the same script: ``_guard_psnr`` returns a
given sequence of values, ``run_stage`` and ``_density_control`` are
replaced by stand-ins that record their calls (stage, primitive count, the
first draw of the boundary rng) and tag what they return. The two packages
must then make the same calls in the same order (attempts, boundary
re-rolls, the (seed, stage, attempt, redo) salt of every boundary rng),
count the same retries and re-rolls, and keep the same candidate. Exact.
A real tiny guarded run checks the metrics fields and the view subsample.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tiny_knot_dataset

from burn_raymarching_tpu.models import scene as jscene
from burn_raymarching_tpu.train.loop import Trainer as JaxTrainer
from burn_raymarching_tpu_torch.models import scene as tscene
from burn_raymarching_tpu_torch.tools import generate
from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset


@pytest.fixture(scope="module")
def knot(tmp_path_factory):
    return tiny_knot_dataset(str(tmp_path_factory.mktemp("knot") / "data"))


class Script:
    """A PSNR sequence to hand out and the trace of calls made."""

    def __init__(self, psnrs):
        self.psnrs = list(psnrs)
        self.trace = []
        self.tag = 0

    def psnr(self):
        value = self.psnrs[len([e for e in self.trace if e[0] == "psnr"])]
        self.trace.append(("psnr", value))
        return value

    def next_tag(self):
        self.tag += 1
        return float(self.tag)


def _drive(trainer_cls, cfg, dataset, script, monkeypatch, make, pad, as_np):
    """Run ``trainer_cls``'s guarded loop under ``script`` → (trainer, the
    tag of the candidate it kept, N of it)."""
    def run_stage(self, params, stage, key, **kw):
        script.trace.append(("run_stage", stage, int(params.n)))
        tagged = make(params, script.next_tag())
        padded, mask = pad(tagged, 8)
        return padded, mask, 0.0

    def density(self, padded, mask, n_live, init_centers, stage, rng):
        script.trace.append(("density", stage, int(n_live),
                             int(rng.integers(1 << 30))))
        grown = make(padded, script.next_tag(), n=min(int(n_live) + 1, 8))
        return grown

    with monkeypatch.context() as m:
        m.setattr(trainer_cls, "run_stage", run_stage)
        m.setattr(trainer_cls, "_density_control", density)
        m.setattr(trainer_cls, "_guard_psnr",
                  lambda self, padded, mask: script.psnr())
        m.setattr(trainer_cls, "save_preview", lambda self, *a, **k: None)
        logs = []
        trainer = trainer_cls(cfg, dataset, log=logs.append)
        padded, mask = trainer.run()
    return trainer, float(as_np(padded.ambient)[0]), int(as_np(mask).sum()), \
        logs


def _make_jax(params, tag, n=None):
    n = params.n if n is None else n
    return jscene.SceneParams(
        centers=jnp.zeros((n, 3)), colors=jnp.zeros((n, 3)),
        radii=jnp.zeros((n, 1)), light_dir=jnp.asarray([0.0, 1.0, 0.0]),
        ambient=jnp.asarray([tag]))


def _make_torch(params, tag, n=None):
    n = params.n if n is None else n
    return tscene.SceneParams(
        torch.zeros((n, 3)), torch.zeros((n, 3)), torch.zeros((n, 1)),
        torch.tensor([0.0, 1.0, 0.0]), torch.tensor([tag]))


HEALTHY = [10, 15, 14.8, 18, 17.9, 20]
# Stage 1 fails twice (entry 14.5, needs >= 14.4), recovers on the third
# attempt; each retry re-rolls the boundary first.
STAGE_RETRIES = [10, 15, 14.5, 14.0, 14.6, 14.2, 14.7, 16, 15.8, 19]
# The first boundary costs 2.0 and 1.5 dB (more than 1.0), then 0.9.
BOUNDARY_REROLLS = [10, 15, 13.0, 13.5, 14.1, 16, 15.9, 19]
# Nothing ever passes: every level keeps its best candidate.
ALL_FAIL = [10, 9, 7, 6, 6.5, 8, 5, 4, 4.5, 7.5, 3, 2, 2.5, 6, 5, 4.4, 4.1,
            4.2, 3, 2, 1, 1.5, 2.5] + [1.0] * 40
SCRIPTS = {"healthy": HEALTHY, "stage retries": STAGE_RETRIES,
           "boundary re-rolls": BOUNDARY_REROLLS, "all fail": ALL_FAIL}
for _seed in range(4):
    SCRIPTS[f"random {_seed}"] = list(np.round(
        np.random.default_rng(_seed).uniform(8.0, 12.0, 120), 3))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_guarded_loop_matches_jax(knot, tmp_path, monkeypatch, name):
    cfg, _, ds, ds_j = knot
    cfg = dataclasses.replace(
        cfg, stages=3, stage_guard=True, stage_guard_retries=2, seed=4,
        init_layout="reference", init_n=5,
        scene_json=str(tmp_path / "scene.json"),
        steps_dir=str(tmp_path / "steps"))
    want, got = Script(SCRIPTS[name]), Script(SCRIPTS[name])
    tr_j, tag_j, n_j, logs_j = _drive(JaxTrainer, cfg, ds_j, want,
                                      monkeypatch, _make_jax,
                                      jscene.pad_params, np.asarray)
    tr_t, tag_t, n_t, logs_t = _drive(Trainer, cfg, ds, got, monkeypatch,
                                      _make_torch, tscene.pad_params, nn)
    assert got.trace == want.trace
    assert (tag_t, n_t) == (tag_j, n_j)
    assert tr_t.guard_retry_count == tr_j.guard_retry_count
    assert (tr_t.guard_boundary_redo_count
            == tr_j.guard_boundary_redo_count)
    guard_lines = [line for line in logs_t if "stage guard" in line]
    assert guard_lines == [line for line in logs_j if "stage guard" in line]
    with open(tmp_path / "scene.json") as f:
        assert json.load(f)["num_spheres"] == n_t
    if name == "healthy":
        assert tr_t.guard_retry_count == tr_t.guard_boundary_redo_count == 0
        assert [e[0] for e in got.trace].count("run_stage") == 3
    if name == "stage retries":
        assert tr_t.guard_retry_count == 2
        assert any("recovered" in line for line in logs_t)
    if name == "boundary re-rolls":
        assert tr_t.guard_boundary_redo_count == 2
    if name == "all fail":
        assert tr_t.guard_retry_count == 6
        assert sum("keeping best attempt" in line for line in logs_t) >= 2


def test_boundary_rng_is_salted_by_seed_stage_attempt_redo(knot, tmp_path,
                                                           monkeypatch):
    cfg, _, ds, _ = knot
    cfg = dataclasses.replace(
        cfg, stages=2, stage_guard=True, stage_guard_retries=1, seed=9,
        init_layout="reference", init_n=5,
        scene_json=str(tmp_path / "scene.json"),
        steps_dir=str(tmp_path / "steps"))
    script = Script([10, 15, 12, 12.5, 11, 13, 13.2, 12] + [1.0] * 20)
    _drive(Trainer, cfg, ds, script, monkeypatch, _make_torch,
           tscene.pad_params, nn)
    draws = [e[3] for e in script.trace if e[0] == "density"]
    salts = [(9, 0, 0, 0), (9, 0, 0, 1), (9, 0, 1, 0), (9, 0, 1, 1)]
    assert draws == [int(np.random.default_rng(s).integers(1 << 30))
                     for s in salts]


@pytest.fixture(scope="module")
def tiny_dango(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dango") / "data")
    generate.main(["--out", out, "--size", "32", "--device", "cpu"])
    return os.path.join(out, "cameras.json")


def _dango_cfg(cameras, tmp_path, **kw):
    from burn_raymarching_tpu_torch.config import TrainConfig

    return TrainConfig(
        batch_size=256, width=32, height=32, stages=2, steps_per_stage=4,
        cameras_json=cameras, checkpoint_dir=None, stage_guard=True,
        scene_json=str(tmp_path / "scene.json"),
        steps_dir=str(tmp_path / "steps"),
        metrics_jsonl=str(tmp_path / "metrics.jsonl"), **kw)


def test_guarded_run_logs_its_metrics(tiny_dango, tmp_path):
    cfg = _dango_cfg(tiny_dango, tmp_path)
    trainer = Trainer(cfg, build_dataset(cfg, device="cpu"),
                      log=lambda s: None)
    padded, mask = trainer.run()
    rows = [r for r in trainer.metrics.read() if "guard_attempt" in r]
    assert [r["stage"] for r in rows if r["guard_attempt"] == 0] == [0, 1]
    for r in rows:
        assert {"guard_psnr_pre", "guard_psnr_post"} <= set(r)
        assert np.isfinite([r["guard_psnr_pre"], r["guard_psnr_post"]]).all()
    assert len(rows) == 2 + trainer.guard_retry_count
    redo = [r for r in trainer.metrics.read() if "guard_boundary_redo" in r]
    assert len(redo) == trainer.guard_boundary_redo_count
    assert os.path.exists(tmp_path / "scene.json")
    assert os.path.exists(tmp_path / "steps" / "stage_0.png")
    assert os.path.exists(tmp_path / "steps" / "final_1.png")
    # The guard's PSNR is the evaluator's under the final render config.
    cams, tgts = trainer._load_views()
    assert trainer._guard_psnr(padded, mask) == pytest.approx(
        trainer.views_psnr(padded, mask, cams, tgts), abs=1e-6)


def test_guard_views_subsample(tiny_dango, tmp_path):
    cfg = _dango_cfg(tiny_dango, tmp_path, stage_guard_views=3)
    trainer = Trainer(cfg, build_dataset(cfg, device="cpu"),
                      log=lambda s: None)
    padded, mask = tscene.pad_params(trainer._init_params(), 8)
    value = trainer._guard_psnr(padded, mask)
    cams, tgts = trainer._guard_eval
    all_cams, _ = trainer._load_views()
    assert [c["file"] for c in cams] == [c["file"] for c in all_cams[::3][:3]]
    assert value == pytest.approx(
        trainer.views_psnr(padded, mask, cams, tgts), abs=1e-6)


def test_unguarded_run_is_unchanged_by_the_guard_code(tiny_dango, tmp_path):
    """stage_guard off: the loop takes the plain path, no guard evaluation,
    counters stay 0."""
    cfg = dataclasses.replace(_dango_cfg(tiny_dango, tmp_path),
                              stage_guard=False)
    trainer = Trainer(cfg, build_dataset(cfg, device="cpu"),
                      log=lambda s: None)
    trainer.run()
    assert trainer._guard_eval is None
    assert trainer.guard_retry_count == trainer.guard_boundary_redo_count == 0
    assert not [r for r in trainer.metrics.read() if "guard_attempt" in r]

"""The per-stage schedules of the quality recipe: sub-pixel supersampling,
the stage-indexed centers learning rate, the per-stage render overrides and
the construction-time checks of the port's Trainer, each against the JAX
package's on the same inputs; and the train CLI's quality flags as tiny CPU
jobs that run to the end.

Tolerances: sub-pixel offsets and expanded rays 1e-6 (pure float32
arithmetic on the same inputs); a supersampled training step's loss rtol
1e-4 (as tests/test_torch_train.py holds a step's) and its gradients 5e-3
of each group's largest entry + 1e-7: the light gradient is a sum of
normal-dependent terms over the rays that nearly cancels, and the dense
case's two marches give normals 1e-4 apart (2e-3 of the largest entry
seen there, 1e-5 in the culled cases, which share one march). Everything
else is exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    KNOT_FLAGS,
    jax_culled_march,
    jax_params,
    knot_params,
    nn,
    tiny_knot_dataset,
    tt,
)

import burn_raymarching_tpu.train.step_body as jsb
from burn_raymarching_tpu.ops.march import march_xla
from burn_raymarching_tpu.train.loop import Trainer as JaxTrainer
from burn_raymarching_tpu_torch.config import DensityConfig, RenderConfig
from burn_raymarching_tpu_torch.models.scene import (
    PARAM_KEYS,
    params_from_numpy,
)
from burn_raymarching_tpu_torch.tools import generate, train_cli
from burn_raymarching_tpu_torch.train import step_body as tsb
from burn_raymarching_tpu_torch.train.loop import Trainer

PX = float(2.0 * np.tan(np.radians(25.0)) / 32)   # the tiny rigs' pixel angle


@pytest.fixture(scope="module")
def knot(tmp_path_factory):
    return tiny_knot_dataset(str(tmp_path_factory.mktemp("knot") / "data"))


@pytest.mark.parametrize("ss", [1, 2, 4, 5, 9])
def test_subpixel_offsets_match_jax(ss):
    got, want = tsb.subpixel_offsets(ss), jsb.subpixel_offsets(ss)
    assert got.shape == (ss, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("ss", [2, 4, 5])
def test_expand_subpixel_matches_jax(ss):
    rng = np.random.default_rng(ss)
    ro = rng.normal(0, 1, (64, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (64, 3)).astype(np.float32)
    rd[:8] = [0.0, 1.0, 0.0]          # the |rd.y| >= 0.9 branch of ``up``
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro_j, rd_j = jsb.expand_subpixel(jnp.asarray(ro), jnp.asarray(rd), ss, PX)
    ro_t, rd_t = tsb.expand_subpixel(tt(ro), tt(rd), ss, PX)
    assert ro_t.shape == (64 * ss, 3)
    np.testing.assert_allclose(nn(ro_t), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(nn(rd_t), np.asarray(rd_j), atol=1e-6)
    # Pixel-major: the ss sub-rays of a pixel are adjacent and share ro.
    np.testing.assert_array_equal(nn(ro_t).reshape(64, ss, 3)[:, 0], ro)


@pytest.mark.parametrize("stage", [None, 0, 1, 2, 3, 7])
def test_lr_scale_tree_stage_schedule_matches_jax(knot, stage):
    cfg = dataclasses.replace(knot[0],
                              lr_scale_centers_stages=(0.001, 0.01, 0.02))
    want = jsb.lr_scale_tree(cfg, None if stage is None
                             else jnp.int32(stage))
    got = tsb.lr_scale_tree(cfg, stage)
    for name in PARAM_KEYS:
        assert got[name] == pytest.approx(float(getattr(want, name)),
                                          rel=1e-7), name
    # Past the schedule's end the last entry holds (polish's stage).
    if stage == 7:
        assert got["centers"] == pytest.approx(0.02, rel=1e-6)
    if stage is None:
        assert got["centers"] == cfg.lr_scale_centers


SCHEDULES = dict(
    coverage_mode_stages=("sigmoid", "gaussian"),
    mask_sharpness_stages=(10.0, 20.0, 40.0),
    supersample_stages=(4, 2, 1),
    mask_px_stages=(1.0, 0.0),
    render=RenderConfig(softmax_sharpness=40.0, mask_sharpness=40.0,
                        coverage_mode="gaussian", pixel_angle=PX))


@pytest.mark.parametrize("stage", [0, 1, 2, 5])
def test_render_overrides_for_stage_match_jax(knot, stage):
    cfg, _, ds, ds_j = knot
    cfg = dataclasses.replace(cfg, batch_size=512, **SCHEDULES)
    tr = Trainer(cfg, ds, log=lambda s: None)
    tr_j = JaxTrainer(cfg, ds_j, log=lambda s: None)
    want = tr_j._render_overrides_for_stage(stage)
    assert tr._render_overrides_for_stage(stage) == want
    assert tr._coverage_for_stage(stage) == tr_j._coverage_for_stage(stage)
    assert tr._stage_cfg(want) == tr_j._stage_cfg(want)
    assert tr._stage_cfg({}) is cfg
    # A stage whose overrides equal the base config reuses the base step;
    # any other gets one closure per distinct override set, built once.
    step = tr._step_for_stage(stage)
    assert (step is tr.step_fn) == (stage >= 2)
    assert tr._step_for_stage(stage) is step
    assert len(tr._step_fns) == (0 if stage >= 2 else 1)


def test_no_schedule_means_no_overrides(knot):
    cfg, _, ds, _ = knot
    tr = Trainer(cfg, ds, log=lambda s: None)
    assert tr._render_overrides_for_stage(0) == {}
    assert tr._step_for_stage(0) is tr.step_fn and tr._step_fns == {}


BAD_CONFIGS = {
    "residual split without culling": (
        dict(use_culling=False, sample_mode="pixel",
             density=DensityConfig(split_mode="residual")), "use_culling"),
    "coverage schedule ends elsewhere": (
        dict(coverage_mode_stages=("sigmoid", "gaussian")),
        "coverage_mode_stages ends"),
    "mask sharpness schedule ends elsewhere": (
        dict(mask_sharpness_stages=(10.0, 40.0)),
        "mask_sharpness_stages ends"),
    "supersample schedule ends above 1": (
        dict(supersample_stages=(4, 4), render=RenderConfig(pixel_angle=PX)),
        "supersample_stages ends"),
    "mask_px schedule ends elsewhere": (
        dict(mask_px_stages=(2.0, 1.0), render=RenderConfig(pixel_angle=PX)),
        "mask_px_stages ends"),
    "supersample schedule without pixel_angle": (
        dict(supersample_stages=(4, 1)), "pixel_angle"),
    "mask_px schedule without pixel_angle": (
        dict(mask_px_stages=(1.0, 0.0)), "pixel_angle"),
    "supersample without pixel_angle": (
        dict(render=RenderConfig(supersample=4)), "pixel_angle"),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_construction_errors_match_jax(knot, case):
    """Each bad configuration raises ValueError at construction in both
    packages, with the same message."""
    cfg, _, ds, ds_j = knot
    overrides, match = BAD_CONFIGS[case]
    bad = dataclasses.replace(cfg, **overrides)
    with pytest.raises(ValueError, match=match) as err_j:
        JaxTrainer(bad, ds_j, log=lambda s: None)
    with pytest.raises(ValueError, match=match) as err_t:
        Trainer(bad, ds, log=lambda s: None)
    assert str(err_t.value) == str(err_j.value)


@pytest.mark.parametrize("batch,ss,tile_mode,match", [
    (250, 4, False, "must divide by supersample"),
    (256, 2, True, "supersample \\* cull_tile")])
def test_supersample_divisibility_errors(knot, batch, ss, tile_mode, match):
    cfg = dataclasses.replace(
        knot[0], render=RenderConfig(supersample=ss, pixel_angle=PX),
        cull_tile=256, sample_mode="tile" if tile_mode else "pixel")
    with pytest.raises(ValueError, match=match):
        tsb.make_device_step(cfg, march_normal_fn=None, batch=batch)


def _grads(params):
    return {k: nn(getattr(params, k).grad) for k in PARAM_KEYS}


@pytest.mark.parametrize("culled,ss", [(False, 4), (True, 2), (True, 4)])
def test_supersampled_step_matches_jax(knot, monkeypatch, culled, ss):
    """One training step at supersample ``ss`` (batch // ss unique pixels,
    pixel-major sub-rays, the prediction averaged per pixel before the
    loss; the culled cases warm-started, so sub-rays share their pixel's
    cached t and the cache takes back their mean) against the JAX package's
    step with the same indices injected into its sampler.

    What is held is the step's wiring, so the float32 noise of two separate
    marches is kept out as tests/test_torch_train.py keeps it out: the
    culled port step marches through the JAX package's
    culled_march_normals_xla, and the dense case runs the reference's soft
    forward (k 5 -> 32, sharpness 10/15), where two marches agree."""
    cfg, _, ds, ds_j = knot
    render = dataclasses.replace(
        cfg.render if culled else RenderConfig(), supersample=ss,
        pixel_angle=PX)
    cfg = dataclasses.replace(
        cfg, batch_size=512, use_culling=culled, cluster_repulsion=False,
        warm_start=culled, sample_mode="tile" if culled else "pixel",
        render=render)
    if not culled:
        cfg = dataclasses.replace(cfg, min_smooth_k=5.0, max_smooth_k=32.0)
    raw, mask = knot_params(cfg)
    n_unique = 512 // ss
    rng = np.random.default_rng(ss)
    n_tiles = ds.num_total_pixels // cfg.cull_tile
    if culled:
        tids = rng.integers(0, n_tiles, n_unique // cfg.cull_tile)
        sampled = tids.astype(np.int32)
        idx = (tids[:, None] * cfg.cull_tile
               + np.arange(cfg.cull_tile)).reshape(-1)
    else:
        idx = rng.integers(0, ds.num_total_pixels, n_unique)
        sampled = idx.astype(np.int32)
    t_cache0 = rng.uniform(1.0, 2.5, ds.num_total_pixels).astype(np.float32)

    monkeypatch.setattr(jsb, "sample_batch_indices",
                        lambda *a, **kw: jnp.asarray(sampled))
    step_j = jsb.make_device_step(
        cfg, march_fn=march_xla, march_normal_fn=None, culled_march_fn=None,
        repulsion_fn=None, batch=512, warm=culled)
    empty = jnp.zeros((0, 0), jnp.int32)
    loss_j, g_j, cache_j, _ = step_j(
        jax_params(raw), jax.random.PRNGKey(0), jnp.int32(0), jnp.int32(1),
        jnp.int32(0), jnp.asarray(mask), ds_j.packed,
        jnp.zeros(n_tiles, jnp.int32), jnp.int32(0), jnp.asarray(t_cache0),
        empty, empty.astype(bool))

    pt = params_from_numpy(raw)
    cache_t = torch.as_tensor(t_cache0.copy())
    step_t = tsb.make_device_step(cfg, march_normal_fn=None, batch=512,
                                  culled_march_fn=jax_culled_march,
                                  warm=culled)
    loss_t, _ = step_t(pt, None, 1, 1, tt(mask), ds.packed,
                       torch.zeros(n_tiles, dtype=torch.int32), 0,
                       idx=tt(idx).long(), t_cache=cache_t)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    for name, got in _grads(pt).items():
        want = np.asarray(getattr(g_j, name))
        np.testing.assert_allclose(
            got, want, atol=5e-3 * np.abs(want).max() + 1e-7, err_msg=name)
    if culled:
        hit = np.asarray(cache_j) < 10.0
        np.testing.assert_allclose(nn(cache_t)[hit], np.asarray(cache_j)[hit],
                                   atol=1e-4)
        assert not np.array_equal(nn(cache_t), t_cache0)


# --- the train CLI's quality flags, each a tiny job run to its end -------- #

@pytest.fixture(scope="module")
def tiny_dango(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dango") / "data")
    generate.main(["--out", out, "--size", "32", "--device", "cpu"])
    return os.path.join(out, "cameras.json")


def _cli(cameras, run_dir, *extra, knot_dir=None):
    base = ["--cameras", cameras, "--width", "32", "--height", "32",
            "--stages", "2", "--steps", "4", "--batch", "256",
            "--scene-out", os.path.join(run_dir, "scene.json"),
            "--steps-dir", os.path.join(run_dir, "steps"),
            "--checkpoint-dir", "", "--device", "cpu"]
    if knot_dir:
        base += ["--init-points", os.path.join(knot_dir, "points.json"),
                 *KNOT_FLAGS]
        base[base.index("--batch") + 1] = "1024"
    return train_cli.main(base + list(extra))


QUALITY_FLAGS = {
    "stage-guard": (False, ["--stage-guard"]),
    "lr-centers-stages": (False, ["--lr-centers-stages", "0.1"]),
    "best-of": (False, ["--best-of", "2"]),
    "polish": (False, ["--polish", "1"]),
    "refine": (True, ["--refine", "1", "--refine-proposals", "4",
                      "--refine-light", "2", "--refine-bias", "residual",
                      "--refine-colors", "0.2", "--refine-temp", "0.05",
                      "--refine-fringe", "2"]),
    "split-mode residual": (True, ["--split-mode", "residual",
                                   "--split-budget", "16"]),
    "coverage-stages": (False, ["--coverage-stages", "sigmoid"]),
    "ss-stages": (False, ["--ss-stages", "4,1", "--pixel-angle", repr(PX)]),
    "mask-px-stages": (False, ["--mask-px-stages", "1,0", "--mask-sharp-stages",
                               "600,15", "--pixel-angle", repr(PX)]),
    "mask-px": (False, ["--mask-px", "1.0", "--pixel-angle", repr(PX)]),
}


@pytest.mark.parametrize("name", sorted(QUALITY_FLAGS))
def test_quality_flags_run_to_the_end(tiny_dango, knot, tmp_path, name):
    on_knot, flags = QUALITY_FLAGS[name]
    knot_dir = os.path.dirname(knot[0].cameras_json) if on_knot else None
    cameras = knot[0].cameras_json if on_knot else tiny_dango
    trainer, padded, mask = _cli(cameras, str(tmp_path), *flags,
                                 knot_dir=knot_dir)
    assert all(np.isfinite(trainer.loss_history))
    for leaf in padded.parameters():
        assert torch.isfinite(leaf).all()
    with open(tmp_path / "scene.json") as f:
        assert json.load(f)["num_spheres"] == int(mask.sum())


def test_best_of_exports_the_better_seed(tiny_dango, tmp_path, capsys):
    trainer, padded, mask = _cli(tiny_dango, str(tmp_path), "--best-of", "2",
                                 "--polish", "1")
    out = capsys.readouterr().out
    seeds = {int(s): float(p) for s, p in __import__("re").findall(
        r"seed (\d+): PSNR mean ([\d.]+)", out)}
    assert set(seeds) == {0, 1}
    best = max(seeds, key=seeds.get)
    assert f"Best seed {best}:" in out and trainer.cfg.seed == best
    # Per-seed exports, no checkpoints, one final export of the winner
    # (polished with export off, so no final_polished.png).
    for s in (0, 1):
        assert os.path.exists(tmp_path / f"scene.json.seed{s}")
        assert os.path.exists(tmp_path / f"steps_seed{s}" / "final_1.png")
    assert trainer.cfg.checkpoint_dir is None
    assert not os.path.exists(tmp_path / f"steps_seed{best}"
                              / "final_polished.png")
    cams, tgts = trainer._load_views()
    psnr = trainer.views_psnr(padded, mask, cams, tgts)
    assert psnr >= seeds[best] - 0.005
    with open(tmp_path / "scene.json") as f:
        assert json.load(f)["num_spheres"] == int(mask.sum())


def test_mask_px_without_pixel_angle_exits(tiny_dango, tmp_path):
    with pytest.raises(SystemExit, match="pixel-angle"):
        _cli(tiny_dango, str(tmp_path), "--mask-px", "1.0")
    with pytest.raises(SystemExit, match="pixel-angle"):
        _cli(tiny_dango, str(tmp_path), "--ss-stages", "4,1")

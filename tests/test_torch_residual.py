"""Residual attribution and the residual split mode: the port's
train/residual.py and train/density.py against the JAX package's on the
same arrays (a tiny knot capture, tests/torch_parity.tiny_knot_dataset).

Tolerances. On the reference's soft forward (k = 32, sharpness 10/15,
radii ~0.2) the scores agree within 1e-4 of the largest score, with the same
top-8 order. On the large-scene forward (k = 128, sharpness 40/60, radii
~0.06) float32 itself does not carry that: against the port's scoring run
in float64 the JAX package's float32 scores are off by 4.3e-4 of the
largest and the port's by 3.9e-4 to 6.0e-4, with one shared march or two
(the softmax at sharpness 40 and the coverage at 60 multiply the ~2e-6
rounding of the expanded |p - c|^2 on silhouette rays). There the port is
held to 2e-3 of the largest score, to the same top-8 order, and to a
float64 gap no more than 2.5x the JAX package's. Two calls of the port are
bitwise equal (a per-tile ``scatter_`` and a fixed-order sum, no float
atomics). Density control is NumPy on both sides with the same
``default_rng`` draws: exact. The JAX side marches through its plain
``culled_march_normals_xla`` (``kern=None``).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import (
    KNOT_FLAGS,
    jax_culled_march,
    jax_params,
    knot_params,
    nn,
    tiny_knot_dataset,
    tt,
)

from burn_raymarching_tpu.train import density as jd
from burn_raymarching_tpu.train.residual import (
    primitive_residual_scores as j_scores,
)
from burn_raymarching_tpu_torch.config import DensityConfig, RenderConfig
from burn_raymarching_tpu_torch.models.scene import params_from_numpy
from burn_raymarching_tpu_torch.tools import train_cli
from burn_raymarching_tpu_torch.train import density as td
from burn_raymarching_tpu_torch.train.loop import Trainer
from burn_raymarching_tpu_torch.train.residual import (
    primitive_residual_scores,
)


@pytest.fixture(scope="module")
def knot(tmp_path_factory):
    return tiny_knot_dataset(str(tmp_path_factory.mktemp("knot") / "data"))


RENDERS = {
    "sigmoid 40/60": RenderConfig(softmax_sharpness=40.0,
                                  mask_sharpness=60.0),
    "gaussian 40/40": RenderConfig(softmax_sharpness=40.0,
                                   mask_sharpness=40.0,
                                   coverage_mode="gaussian"),
    "pixel-area mask": RenderConfig(
        softmax_sharpness=40.0, mask_sharpness=600.0, mask_pixel_mult=1.0,
        pixel_angle=float(2.0 * np.tan(np.radians(25.0)) / 32)),
}


def _scores_float64(raw, mask, ds, cfg, smooth_k):
    """The port's scoring with every tensor in float64."""
    import types

    import torch

    from burn_raymarching_tpu_torch.train.residual import _score_chunk_culled

    p64 = types.SimpleNamespace(**{k: tt(v).double() for k, v in raw.items()})
    packed = ds.packed.double()
    chunk = (cfg.batch_size // cfg.cull_tile) * cfg.cull_tile
    total = torch.zeros(raw["centers"].shape[0], dtype=torch.float64)
    for ci in range(ds.num_total_pixels // chunk):
        rows = packed[ci * chunk:(ci + 1) * chunk]
        total += _score_chunk_culled(
            p64, tt(mask), rows[:, 0:3].contiguous(),
            rows[:, 3:6].contiguous(), rows[:, 6:9].contiguous(), smooth_k,
            cfg, None)
    return total.numpy()


def test_scores_match_jax_on_the_soft_forward(knot):
    cfg, _, ds, ds_j = knot
    cfg = dataclasses.replace(cfg, render=RenderConfig())
    raw, mask = knot_params(cfg, raw_radius=-1.5)
    want = j_scores(jax_params(raw), jnp.asarray(mask), ds_j, cfg, 32.0)
    got = primitive_residual_scores(params_from_numpy(raw), tt(mask), ds,
                                    cfg, 32.0)
    assert got.shape == want.shape == (128,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * want.max())
    np.testing.assert_array_equal(np.argsort(-got)[:8],
                                  np.argsort(-want)[:8])
    assert (got[~mask] == 0).all() and got.max() > 0


@pytest.mark.parametrize("render", sorted(RENDERS))
def test_scores_match_jax(knot, render):
    cfg, _, ds, ds_j = knot
    cfg = dataclasses.replace(cfg, render=RENDERS[render])
    raw, mask = knot_params(cfg)
    want = j_scores(jax_params(raw), jnp.asarray(mask), ds_j, cfg, 128.0)
    ref = _scores_float64(raw, mask, ds, cfg, 128.0)
    gap_jax = np.abs(want - ref).max()
    for kern in (None, jax_culled_march):
        got = primitive_residual_scores(params_from_numpy(raw), tt(mask), ds,
                                        cfg, 128.0, kern=kern)
        np.testing.assert_allclose(got, want, atol=2e-3 * want.max())
        np.testing.assert_array_equal(np.argsort(-got)[:8],
                                      np.argsort(-want)[:8])
        assert np.abs(got - ref).max() <= 2.5 * gap_jax
        assert (got[~mask] == 0).all() and got.max() > 0


def test_scores_are_bitwise_repeatable(knot):
    cfg, _, ds, _ = knot
    raw, mask = knot_params(cfg, seed=3)
    first = primitive_residual_scores(params_from_numpy(raw), tt(mask), ds,
                                      cfg, 128.0)
    second = primitive_residual_scores(params_from_numpy(raw), tt(mask), ds,
                                       cfg, 128.0)
    assert first.tobytes() == second.tobytes()


def test_scores_subsample_stride_matches_jax(knot):
    """``max_pixels`` below the dataset: the same strided chunks are
    scored."""
    cfg, _, ds, ds_j = knot
    raw, mask = knot_params(cfg, seed=1)
    want = j_scores(jax_params(raw), jnp.asarray(mask), ds_j, cfg, 128.0,
                    max_pixels=512)
    got = primitive_residual_scores(params_from_numpy(raw), tt(mask), ds,
                                    cfg, 128.0, max_pixels=512,
                                    kern=jax_culled_march)
    full = primitive_residual_scores(params_from_numpy(raw), tt(mask), ds,
                                     cfg, 128.0)
    np.testing.assert_allclose(got, want, atol=2e-3 * want.max())
    assert got.sum() < 0.5 * full.sum()


@pytest.mark.parametrize("overrides,match", [
    (dict(batch_size=32), "batch_size"),
    (dict(cull_tile=4096, batch_size=4096), "one cull tile")])
def test_scoring_errors_match_jax(knot, overrides, match):
    cfg, _, ds, ds_j = knot
    bad = dataclasses.replace(cfg, **overrides)
    raw, mask = knot_params(cfg)
    with pytest.raises(ValueError, match=match) as err_j:
        j_scores(jax_params(raw), jnp.asarray(mask), ds_j, bad, 128.0)
    with pytest.raises(ValueError, match=match) as err_t:
        primitive_residual_scores(params_from_numpy(raw), tt(mask), ds, bad,
                                  128.0)
    assert str(err_t.value) == str(err_j.value)


def _cloud(seed, m=200):
    rng = np.random.default_rng(seed)
    centers = (rng.integers(0, 12, (m, 1)) * 0.05 - 0.3
               + rng.normal(0, 0.01, (m, 3))).astype(np.float32)
    colors = rng.normal(0, 1.5, (m, 3)).astype(np.float32)
    colors[:5] = -8.0                       # black: pruned
    radii = rng.normal(-3.0, 0.5, (m, 1)).astype(np.float32)
    radii[5:8] = -9.0                       # too small: pruned
    centers[8:10] = 2.0                     # flyaway: pruned
    init = centers + rng.normal(0, 0.03, (m, 3)).astype(np.float32)
    scores = rng.gamma(1.0, 1.0, m).astype(np.float32)
    scores[rng.integers(0, m, 20)] = 0.0    # never split
    return centers, colors, radii, init, scores


@pytest.mark.parametrize("seed,stage,merge_cell,budget", [
    (0, 0, 0.0, 0), (1, 0, 0.04, 0), (2, 1, 0.04, 16), (3, 2, 0.04, 0),
    (4, 1, 0.1, 1000), (5, 0, 0.0, 7)])
def test_prune_and_split_residual_equals_jax(seed, stage, merge_cell,
                                             budget):
    """split_mode="residual": prune, merge (scores summed per cell), split
    the top scorers; the last stage (2 of 3) splits nothing. Exact."""
    centers, colors, radii, init, scores = _cloud(seed)
    kw = dict(split_mode="residual", merge_cell=merge_cell,
              split_budget=budget)
    want = jd.prune_and_split(centers, colors, radii, init, stage, 3,
                              np.random.default_rng(seed),
                              jd.DensityConfig(**kw), split_scores=scores)
    got = td.prune_and_split(centers, colors, radii, init, stage, 3,
                             np.random.default_rng(seed),
                             DensityConfig(**kw), split_scores=scores)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])
    assert got[3].pruned_black + got[3].pruned_size + got[3].pruned_flyaway
    assert (got[3].split > 0) == (stage < 2)


@pytest.mark.parametrize("cell", [0.0, 0.04, 0.2])
def test_merge_redundant_with_scores_equals_jax(cell):
    centers, colors, radii, _, scores = _cloud(7)
    want = jd.merge_redundant(centers, colors, radii, cell, scores=scores)
    got = td.merge_redundant(centers, colors, radii, cell, scores=scores)
    assert len(got) == len(want) == 5 and got[3] == want[3]
    for a, b in zip(got[:3] + got[4:], want[:3] + want[4:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[4].sum(), scores.sum(), rtol=1e-5)


def test_residual_mode_needs_scores():
    centers, colors, radii, init, _ = _cloud(0)
    with pytest.raises(ValueError, match="split_scores"):
        td.prune_and_split(centers, colors, radii, init, 0, 3,
                           np.random.default_rng(0),
                           DensityConfig(split_mode="residual"))


def test_density_control_scores_under_the_stage_forward(knot, monkeypatch):
    """Trainer._density_control in residual mode scores with the stage's
    render overrides and its end-of-stage k, hands the live rows' scores to
    prune_and_split, and the boundary grows N."""
    import burn_raymarching_tpu_torch.train.loop as tloop

    cfg, _, ds, _ = knot
    cfg = dataclasses.replace(
        cfg, stages=3, coverage_mode_stages=("sigmoid", "gaussian"),
        render=dataclasses.replace(cfg.render, coverage_mode="gaussian",
                                   mask_sharpness=40.0),
        density=DensityConfig(split_mode="residual", split_budget=10))
    seen = {}
    real = tloop.primitive_residual_scores

    def spy(padded, mask, dataset, score_cfg, smooth_k, kern=None, **kw):
        seen.update(coverage=score_cfg.render.coverage_mode, k=smooth_k,
                    kern=kern)
        return real(padded, mask, dataset, score_cfg, smooth_k, kern=kern,
                    **kw)

    monkeypatch.setattr(tloop, "primitive_residual_scores", spy)
    logs = []
    tr = Trainer(cfg, ds, log=logs.append)
    raw, mask = knot_params(cfg)
    nxt = tr._density_control(params_from_numpy(raw), tt(mask), cfg.init_n,
                              raw["centers"][:cfg.init_n], 0,
                              np.random.default_rng(0))
    assert seen == {"coverage": "sigmoid", "k": 128.0, "kern": None}
    assert any("split 10" in line for line in logs)
    tr._density_control(params_from_numpy(raw), tt(mask), cfg.init_n,
                        raw["centers"][:cfg.init_n], 1,
                        np.random.default_rng(0))
    assert seen["coverage"] == "gaussian"
    assert nxt.n == int(nn(nxt.centers).shape[0]) > 0


def test_training_grows_n_across_a_residual_boundary(knot, tmp_path):
    """The reference rule never splits these 0.03-radius spheres; the
    residual rule does, so N grows across the boundary where the reference
    mode only merges."""
    def run(*flags):
        return train_cli.main([
            "--cameras", knot[0].cameras_json, "--width", "32", "--height",
            "32", "--stages", "2", "--steps", "3", "--batch", "1024",
            "--init-points", knot[0].init_points,
            "--scene-out", str(tmp_path / "scene.json"),
            "--steps-dir", str(tmp_path / "steps"), "--checkpoint-dir", "",
            "--device", "cpu", *KNOT_FLAGS, *flags])

    _, _, mask_ref = run()
    _, _, mask_res = run("--split-mode", "residual", "--split-budget", "20")
    assert int(mask_res.sum()) == int(mask_ref.sum()) + 20
    assert os.path.exists(tmp_path / "scene.json")

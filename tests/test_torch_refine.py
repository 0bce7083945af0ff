"""Derivative-free refinement: the port's train/refine.py and the Trainer's
polish / refine_geometry against the JAX package's on the same arrays (a
tiny knot capture, tests/torch_parity.tiny_knot_dataset), with the
proposal noise drawn from ``jax.random`` exactly as the JAX package draws
it and injected into the port's ``draws`` hook
(tests/torch_parity.jax_refine_draws).

Both packages march through the JAX package's plain
``culled_march_normals_xla`` (its ``kern=None``; handed to the port as its
``kern``), so what is compared is the acceptance loss's tail and the
chains. Tolerances: the acceptance loss 1e-5 relative (a mean over ~1,500
float32 terms, summed slice by slice in the port), and 1e-6 relative
between two slice sizes of the port; a chain of 36 proposals: the same
accepted count in every phase and final parameters within 1e-4 (one
differing decision moves a parameter by ~1e-2); losses 1e-4 relative.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_culled_march,
    jax_params,
    jax_refine_draws,
    knot_params,
    nn,
    tiny_knot_dataset,
    tt,
)

from burn_raymarching_tpu.train import refine as jr
from burn_raymarching_tpu_torch.config import RenderConfig
from burn_raymarching_tpu_torch.models.scene import (
    PARAM_KEYS,
    params_from_numpy,
)
from burn_raymarching_tpu_torch.train import refine as tr
from burn_raymarching_tpu_torch.train.loop import Trainer


@pytest.fixture(scope="module")
def knot(tmp_path_factory):
    return tiny_knot_dataset(str(tmp_path_factory.mktemp("knot") / "data"))


def _batches(knot, tiles=4, seed=3):
    cfg, _, ds, ds_j = knot
    return (tr.sample_fg_tile_batches(ds, tiles, seed=seed,
                                      tile=cfg.cull_tile),
            jr.sample_fg_tile_batches(ds_j, tiles, seed=seed,
                                      tile=cfg.cull_tile))


@pytest.mark.parametrize("tiles,seed", [(2, 0), (4, 1), (100, 2)])
def test_fg_tile_batches_disjoint_and_equal_to_jax(knot, tiles, seed):
    """The same foreground tiles as the JAX package picks, batch for batch;
    a request beyond the pool divides what there is evenly."""
    cfg, _, ds, ds_j = knot
    got, want = _batches(knot, tiles, seed)
    idx = tr.fg_tile_batch_indices(ds, tiles, seed=seed, tile=cfg.cull_tile)
    assert len(got) == len(want) == 2
    assert not set(idx[0]) & set(idx[1])
    n_fg = ds.tile_fg(cfg.cull_tile)[1]
    assert len(idx[0]) == len(idx[1]) == min(tiles, n_fg // 2) * cfg.cull_tile
    for (ro, rd, tgt), (ro_j, rd_j, tgt_j), ids in zip(got, want, idx):
        np.testing.assert_array_equal(nn(ro), np.asarray(ro_j))
        np.testing.assert_array_equal(nn(rd), np.asarray(rd_j))
        np.testing.assert_array_equal(nn(tgt), np.asarray(tgt_j))
        # Whole tiles, every one with a foreground pixel.
        tiles_of = np.unique(ids // cfg.cull_tile)
        assert len(tiles_of) * cfg.cull_tile == len(ids)
        assert (nn(tgt).reshape(len(tiles_of), -1).sum(axis=1)
                > ds.fg_threshold).all()


def test_fg_tile_batches_need_enough_tiles(knot):
    cfg, _, ds, _ = knot
    with pytest.raises(ValueError, match="fg tiles"):
        tr.sample_fg_tile_batches(ds, 2, tile=cfg.cull_tile, n_batches=999)


LOSS_CASES = {
    "sigmoid": (RenderConfig(softmax_sharpness=40.0, mask_sharpness=60.0),
                1.0),
    "sigmoid, fringe 4": (RenderConfig(softmax_sharpness=40.0,
                                       mask_sharpness=60.0), 4.0),
    "gaussian, fringe 4": (RenderConfig(softmax_sharpness=40.0,
                                        mask_sharpness=40.0,
                                        coverage_mode="gaussian"), 4.0),
    "gaussian": (RenderConfig(softmax_sharpness=40.0, mask_sharpness=40.0,
                              coverage_mode="gaussian"), 1.0),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_acceptance_loss_matches_jax(knot, case):
    render, fringe = LOSS_CASES[case]
    cfg = dataclasses.replace(knot[0], render=render)
    raw, mask = knot_params(cfg)
    (batch, _), (batch_j, _) = _batches(knot)
    want = float(jr._make_loss_on(cfg, jnp.asarray(mask), None, 64, fringe)(
        jax_params(raw), *batch_j))
    params = params_from_numpy(raw)
    got = {s: float(tr._make_loss_on(cfg, tt(mask), jax_culled_march, 64,
                                     fringe, tile_slice=s)(params, *batch))
           for s in (1, 3, 64)}
    assert got[64] == pytest.approx(want, rel=1e-5)
    assert got[1] == pytest.approx(got[64], rel=1e-6)
    assert got[3] == pytest.approx(got[64], rel=1e-6)
    if fringe != 1.0:
        plain = float(tr._make_loss_on(cfg, tt(mask), jax_culled_march, 64,
                                       1.0)(params, *batch))
        assert got[64] > plain


def test_acceptance_loss_uses_the_capped_budget(knot):
    """``k_budget`` below the qualifying sets truncates the tables: the
    loss moves, and it is still the JAX package's."""
    cfg = knot[0]
    raw, mask = knot_params(cfg)
    (batch, _), (batch_j, _) = _batches(knot)
    want = float(jr._make_loss_on(cfg, jnp.asarray(mask), None, 4, 1.0)(
        jax_params(raw), *batch_j))
    params = params_from_numpy(raw)
    got = float(tr._make_loss_on(cfg, tt(mask), jax_culled_march, 4, 1.0)(
        params, *batch))
    full = float(tr._make_loss_on(cfg, tt(mask), jax_culled_march, 64, 1.0)(
        params, *batch))
    assert got == pytest.approx(want, rel=1e-4) and got != full


def test_budget_cap_is_config_and_logged(knot):
    cfg = dataclasses.replace(knot[0], cull_budget=64, refine_max_budget=16)
    logs = []
    assert tr._capped_budget(cfg, logs.append) == 16
    assert len(logs) == 1 and "64 -> 16" in logs[0]
    assert "refine_max_budget" in logs[0]
    logs_j = []
    assert jr._capped_budget(cfg, logs_j.append) == 16 and logs_j == logs
    assert tr._capped_budget(knot[0], logs.append) == 64 and len(logs) == 1


@pytest.mark.parametrize("k_budget", [64, 2048, 4096, 8192, 1 << 20])
def test_auto_chunk_matches_jax(k_budget):
    assert tr._auto_chunk(k_budget) == jr._auto_chunk(k_budget)
    assert tr._resolve_chunk(None, k_budget) == jr._auto_chunk(k_budget)
    assert tr._resolve_chunk(5, k_budget) == 5


def test_resolve_chunk_rejects_zero():
    with pytest.raises(ValueError, match="chunk"):
        tr._resolve_chunk(0, 2048)


def test_selection_probs_keep_the_expected_count(knot):
    raw, mask = knot_params(knot[0])
    n_live = int(mask.sum())
    uniform = tr.selection_probs(tt(mask), 0.05)
    assert uniform.shape == (128, 1)
    assert float(uniform.min()) == float(uniform.max()) == np.float32(0.05)
    rng = np.random.default_rng(0)
    scores = rng.gamma(0.5, 1.0, 128).astype(np.float32)
    scores[3] = -1.0                                # clamped to 0
    p = tr.selection_probs(tt(mask), 0.05, scores)
    assert float(p.max()) < 1.0                     # nothing clipped here
    assert float(p.sum()) == pytest.approx(0.05 * n_live, rel=1e-5)
    assert float(p[3]) == 0.0 and float(p[~tt(mask)].abs().sum()) == 0.0
    # The weights' order is kept.
    live = np.flatnonzero(mask)
    np.testing.assert_array_equal(np.argsort(nn(p)[live, 0]),
                                  np.argsort(np.maximum(scores[live], 0)))
    # A weight vector that would push a slot past 1 is clipped.
    spike = np.zeros(128, np.float32)
    spike[0] = 1.0
    assert float(tr.selection_probs(tt(mask), 0.05, spike).max()) == 1.0


def _phase_counts(logs, word="refine phase"):
    return [int(m.group(1)) for line in logs
            if word in line for m in [re.search(r"accepted (\d+)", line)]]


CHAINS = {
    "greedy": dict(),
    "greedy, residual bias, colours, fringe": dict(
        sigma_col=0.3, fringe_weight=4.0, bias=True),
    # T = 0.003 x the baseline loss: about the loss change of a proposal,
    # so the chain does take uphill moves and still finds improvements.
    "annealed": dict(accept_temp=0.003),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_geometry_refine_chain_matches_jax(knot, case):
    """3 phases x 12 chunks of one proposal: the accepted count of every
    phase, the final parameters and the losses, with the JAX package's own
    noise injected.

    The JAX package's jitted chain and its own eager loss differ by up to
    6e-5 relative (XLA fuses the tail), so a decision whose margin is
    smaller than that is a toss-up between any two implementations. The
    test keeps the margins large: spheres twice too fat (radius ~0.2), a
    tenth of them moved per proposal, three phases (the last at 1/4 of the
    noise); an accepted proposal then lowers the loss by ~2e-3 of itself.
    At six phases on a near-converged scene the late decisions did flip."""
    kw = dict(CHAINS[case])
    cfg = knot[0]
    raw, mask = knot_params(cfg, raw_radius=-1.5)
    batches, batches_j = _batches(knot)
    rng = np.random.default_rng(1)
    bias = (rng.gamma(0.5, 1.0, 128).astype(np.float32)
            if kw.pop("bias", False) else None)
    common = dict(proposals=12, phases=3, frac=0.1, sigma_c=0.5,
                  sigma_r=0.5, chunk=1, **kw)
    key = jax.random.PRNGKey(5)
    logs_j, logs_t = [], []
    want, stats_j = jr.geometry_refine(
        jax_params(raw), jnp.asarray(mask), batches_j, cfg, key=key,
        select_probs=None if bias is None else jnp.asarray(bias),
        log=logs_j.append, **common)
    got, stats_t = tr.geometry_refine(
        params_from_numpy(raw), tt(mask), batches, cfg,
        kern=jax_culled_march, select_probs=bias,
        draws=jax_refine_draws(key, 128, 36), log=logs_t.append, **common)
    assert _phase_counts(logs_t) == _phase_counts(logs_j)
    assert stats_t.proposals == stats_j.proposals == 36
    assert stats_t.accepted == stats_j.accepted
    assert 0 < stats_t.accepted < 36
    assert stats_t.loss_before == pytest.approx(stats_j.loss_before,
                                                rel=1e-4)
    assert stats_t.loss_after == pytest.approx(stats_j.loss_after, rel=1e-4)
    assert stats_t.loss_after < stats_t.loss_before
    for name in PARAM_KEYS:
        np.testing.assert_allclose(nn(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, err_msg=name)
    # Only live geometry (and colours when asked) moved; the light did not.
    assert np.array_equal(nn(got.light_dir), raw["light_dir"])
    assert np.array_equal(nn(got.centers)[~mask], raw["centers"][~mask])
    assert (nn(got.colors) != raw["colors"]).any() == ("sigma_col" in kw)


def test_light_refine_chain_matches_jax(knot):
    cfg = knot[0]
    raw, mask = knot_params(cfg)
    raw["light_dir"] = np.asarray([0.5, 0.2, 0.3], np.float32)   # off-optimum
    batches, batches_j = _batches(knot)
    key = jax.random.PRNGKey(9)
    logs_j, logs_t = [], []
    common = dict(proposals=8, phases=2, sigma_dir=0.3, sigma_amb=0.3)
    want, stats_j = jr.light_refine(
        jax_params(raw), jnp.asarray(mask), batches_j, cfg, key=key,
        log=logs_j.append, **common)
    got, stats_t = tr.light_refine(
        params_from_numpy(raw), tt(mask), batches, cfg,
        kern=jax_culled_march,
        draws=jax_refine_draws(key, 128, 2, light=True),
        log=logs_t.append, **common)
    assert (_phase_counts(logs_t, "light-refine")
            == _phase_counts(logs_j, "light-refine"))
    assert stats_t.proposals == stats_j.proposals == 16
    assert stats_t.accepted == stats_j.accepted > 0
    assert stats_t.loss_after == pytest.approx(stats_j.loss_after, rel=1e-4)
    for name in PARAM_KEYS:
        np.testing.assert_allclose(nn(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, err_msg=name)
    assert np.array_equal(nn(got.centers), raw["centers"])
    assert not np.array_equal(nn(got.light_dir), raw["light_dir"])


def test_refine_with_its_own_generator_descends(knot):
    """Without injected draws: the torch.Generator path, seeded, is
    repeatable, descends, and reads the accepted count once per chunk."""
    cfg = knot[0]
    raw, mask = knot_params(cfg)
    batches, _ = _batches(knot)

    def run():
        gen = torch.Generator().manual_seed(11)
        return tr.geometry_refine(
            params_from_numpy(raw), tt(mask), batches, cfg, proposals=8,
            phases=2, frac=0.2, sigma_c=0.5, chunk=4, generator=gen,
            log=lambda s: None)

    (a, stats_a), (b, stats_b) = run(), run()
    assert stats_a == stats_b and stats_a.proposals == 16
    assert stats_a.loss_after < stats_a.loss_before
    for name in PARAM_KEYS:
        assert torch.equal(getattr(a, name), getattr(b, name))


@pytest.fixture(scope="module")
def trained(knot, tmp_path_factory):
    """A trainer on the tiny knot and a briefly trained scene."""
    out = tmp_path_factory.mktemp("run")
    cfg = dataclasses.replace(
        knot[0], stages=2, steps_per_stage=4, batch_size=1024,
        scene_json=str(out / "scene.json"), steps_dir=str(out / "steps"))
    logs = []
    trainer = Trainer(cfg, knot[2], log=logs.append)
    padded, mask = trainer.run()
    return trainer, padded, mask, logs, out


def _psnr(trainer, padded, mask):
    return trainer.views_psnr(padded, mask)


def test_polish_never_returns_a_lower_psnr(trained):
    trainer, padded, mask, logs, out = trained
    before = _psnr(trainer, padded, mask)
    n_logs = len(logs)
    polished, pmask = trainer.polish(padded, mask, rounds=2)
    assert _psnr(trainer, polished, pmask) >= before
    assert int(pmask.sum()) == int(mask.sum())
    rounds = [line for line in logs[n_logs:] if "Polish round" in line]
    assert len(rounds) == 2
    assert os.path.exists(out / "scene.json")
    assert os.path.exists(out / "steps" / "final_polished.png")
    # The anneals are pinned at their final values: k is max_smooth_k.
    assert any("k: 128.0" in line for line in logs[n_logs:])


def test_polish_reverts_a_round_that_does_not_improve(trained, monkeypatch):
    trainer, padded, mask, logs, _ = trained
    seq = iter([30.0, 29.0, 30.0])      # baseline, worse, equal: both revert
    monkeypatch.setattr(Trainer, "views_psnr", lambda *a, **k: next(seq))
    n_logs = len(logs)
    got, _ = trainer.polish(padded, mask, rounds=2, export=False)
    assert got is padded
    assert sum("reverted" in line for line in logs[n_logs:]) == 2


def test_refine_geometry_never_returns_a_lower_psnr(trained):
    trainer, padded, mask, logs, out = trained
    before = _psnr(trainer, padded, mask)
    os.remove(out / "scene.json")
    refined, rmask = trainer.refine_geometry(
        padded, mask, rounds=2, proposals=4, phases=2, tiles=4, chunk=4,
        proposal_bias="residual", sigma_col=0.2, fringe_weight=2.0,
        light_proposals=4)
    assert _psnr(trainer, refined, rmask) >= before
    assert rmask is mask and os.path.exists(out / "scene.json")
    lines = [line for line in logs if "Refine round" in line]
    assert len(lines) == 2 and "/16 proposals" in lines[0]


def test_events_record_each_gated_round(trained, monkeypatch):
    """``Trainer.events``: one record per polish and refine round with the
    baseline it was held to, its PSNR and the gate's decision (what callers
    read in place of the log), after the density record of the run's one
    boundary."""
    trainer, padded, mask, _, _ = trained
    boundary = [e for e in trainer.events if e["kind"] == "density"]
    assert len(boundary) == 1 and boundary[0]["stage"] == 0
    assert boundary[0]["n_before"] == trainer.cfg.init_n
    assert boundary[0]["n_after"] == int(mask.sum())
    # baseline, worse (reverted), better (kept); then refine: baseline, better
    seq = iter([30.0, 29.0, 31.0, 31.0, 31.5])
    monkeypatch.setattr(Trainer, "views_psnr", lambda *a, **k: next(seq))
    n_events = len(trainer.events)
    polished, pmask = trainer.polish(padded, mask, rounds=2, export=False)
    trainer.refine_geometry(polished, pmask, rounds=1, proposals=4, phases=1,
                            tiles=4, chunk=4, light_proposals=2,
                            export=False)
    new = trainer.events[n_events:]
    assert [e["kind"] for e in new] == ["polish", "polish", "refine"]
    assert [(e["round"], e["baseline"], e["psnr"], e["kept"])
            for e in new] == [(1, 30.0, 29.0, False), (2, 30.0, 31.0, True),
                              (1, 31.0, 31.5, True)]
    assert new[2]["proposals"] == 4 + 2 * 2      # light: 2 phases of 2
    assert 0 <= new[2]["accepted"] <= new[2]["proposals"]
    json.dumps(trainer.events)                   # plain numbers throughout


def test_refine_geometry_requires_culling_and_a_known_bias(knot, trained):
    trainer, padded, mask, _, _ = trained
    dense = dataclasses.replace(knot[0], use_culling=False,
                                sample_mode="pixel")
    with pytest.raises(ValueError, match="use_culling"):
        Trainer(dense, knot[2], log=lambda s: None).refine_geometry(
            padded, mask)
    with pytest.raises(ValueError, match="proposal_bias"):
        trainer.refine_geometry(padded, mask, proposal_bias="nope")

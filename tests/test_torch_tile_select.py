"""K7, flat per-tile selection in one launch (ops/cuda/tile_select_kernel.py,
csrc/tile_select.cu), against its oracle, the plain selection
(tile_cones + select_tile_primitives + the gathers: ``tile_select_plain``).

On the CPU: the rules the plain path holds and the kernel must repeat,
against a NumPy statement of them (kept rows by (score, row), then the rows
not kept in ascending order, the first min(K, M); valid on the kept rows),
on tiles with scores spread out, tiles keeping more than K with the cloud
init's exact −radius ties, masked rows, a tile keeping nothing and fewer
rows than the budget; the wrapper on CPU tensors is the plain version, in
``culled_tables`` and in a culled step.

On the card (``cuda``): K7 against the plain selection run on K7's own
cones (chip_smoke.k7_compare: slots equal but where a score lies within
1e-6·(1 + |score|) of the one the plain table holds there, of the tile's
cutoff or of an overflowing tile's K-th score; the invalid tail ascending;
cs, rs, qs bitwise the gathers of its idx) on config 4's ray tiles at
M ∈ {16, 128, 2,048, 8,192, 51,200, 65,536} and K ∈ {16, 256, 2,048,
4,096}, and on the CPU cases; its cones against tile_cones; a repeat and a
captured graph's replay bitwise; a captured config-4 step through K7
against one through the plain selection, within the culled-step tests'
tolerances (tests/test_torch_culled_step.py); and a captured step's
selection through K7 alone.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch_parity import cuda_device, nn  # noqa: F401  (a fixture)

from burn_raymarching_tpu_torch.config import RenderConfig, TrainConfig
from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7
from burn_raymarching_tpu_torch.ops.culling import (
    CULL_MARGIN,
    cone_point_distance,
    tile_cones,
)

B, T = 4, 24
SMOOTH_K = 128.0
CASES = ("spread", "overflow_ties", "masked", "empty_tile", "few_rows")


def _case(name: str):
    """B tiles of T rays (one 6x4 camera each) and a table → (ro, rd,
    centers, radii, mask or None, k_budget). ``overflow_ties``: 40 rows of
    one radius inside every tile's cone (they all score exactly −radius),
    interleaved with 20 far rows, K = 16; otherwise K = 24, which some
    tiles' kept rows exceed and others do not; ``empty_tile``: the last
    camera looks away from every row."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays

    rng = np.random.default_rng(CASES.index(name))
    ros, rds = [], []
    for b in range(B):
        eye = [0.3 * b - 0.4, 0.4, -2.5]
        target = ([0, 0, -6.0] if name == "empty_tile" and b == B - 1
                  else [0, 0, 0])
        ro, rd = create_camera_rays(6, 4, eye, target, 30.0, device="cpu")
        ros.append(ro)
        rds.append(rd)
    ro, rd = torch.cat(ros), torch.cat(rds)
    m, budget, mask = 60, 24, None
    centers = rng.normal(0, 1.2, (m, 3))
    radii = 0.02 + 0.1 * rng.random(m)
    if name == "overflow_ties":
        budget = 16
        inside = rng.permutation(m)[:40]
        centers[inside] = rng.normal(0, 0.05, (40, 3))
        radii[inside] = 0.03
        far = np.setdiff1d(np.arange(m), inside)
        centers[far] = rng.normal(0, 0.3, (far.size, 3)) + [4.0, 0, 0]
    if name == "masked":
        mask = torch.as_tensor(rng.random(m) < 0.5)
    if name == "few_rows":
        centers, radii = centers[:10], radii[:10]
    return (ro, rd, torch.as_tensor(centers, dtype=torch.float32),
            torch.as_tensor(radii[:, None], dtype=torch.float32), mask,
            budget)


def _rule(ro, rd, centers, radii, mask, budget):
    """The selection rule in NumPy on the plain scores and cutoff → (idx,
    valid) [B, min(K, M)], and the plain scores [B, M]."""
    cones = tile_cones(ro, rd, T)
    score = nn(cone_point_distance(cones, centers) - radii.reshape(1, -1))
    cutoff = nn(CULL_MARGIN / SMOOTH_K + cones.origin_spread)
    live = np.ones(score.shape[1], bool) if mask is None else nn(mask)
    kk = min(budget, score.shape[1])
    idx, valid = [], []
    for s, cut in zip(score, cutoff):
        kept = (s <= cut) & live
        rows = np.arange(s.size)
        order = sorted(rows[kept], key=lambda i: (s[i], i)) + list(
            rows[~kept])
        idx.append(order[:kk])
        valid.append([bool(kept[i]) for i in order[:kk]])
    return np.asarray(idx), np.asarray(valid), score


@pytest.mark.parametrize("name", CASES)
def test_the_plain_selection_keeps_the_rule(name):
    """Kept rows by (score, row), then the rows not kept ascending; exact
    ties to the lower row; valid exactly on the kept rows; the gathers."""
    ro, rd, c, r, mask, budget = _case(name)
    idx, valid, cs, rs, qs = k7.tile_select_plain(ro, rd, T, c, r, SMOOTH_K,
                                                  budget, mask)
    want_idx, want_valid, score = _rule(ro, rd, c, r, mask, budget)
    np.testing.assert_array_equal(nn(idx), want_idx)
    np.testing.assert_array_equal(nn(valid), want_valid)
    np.testing.assert_array_equal(nn(cs), nn(c)[want_idx])
    np.testing.assert_array_equal(nn(rs), nn(r)[want_idx, 0])
    assert np.all(nn(qs)[~want_valid] == np.float32(1e30))
    n_valid = want_valid.sum(axis=1)
    if name == "overflow_ties":
        assert np.all(n_valid == budget)
        ties = np.float32(-0.03)
        for b in range(B):
            tied = np.nonzero(score[b] == ties)[0]
            assert tied.size > budget
            np.testing.assert_array_equal(want_idx[b], tied[:budget])
    if name == "empty_tile":
        assert n_valid[-1] == 0
        np.testing.assert_array_equal(want_idx[-1], np.arange(budget))
    if name == "few_rows":
        assert want_idx.shape == (B, 10)
    if name == "spread":
        assert n_valid.min() < budget and n_valid.max() == budget
    if name == "masked":
        assert not np.any(nn(mask)[want_idx[want_valid]] == 0)


def test_the_wrapper_on_cpu_tensors_is_the_plain_selection():
    """tile_select on CPU tensors returns the plain version's tensors
    bitwise; culled_tables' flat path is it; the launch itself refuses CPU
    tensors."""
    from burn_raymarching_tpu_torch.train.step_body import culled_tables

    ro, rd, c, r, mask, budget = _case("masked")
    plain = k7.tile_select_plain(ro, rd, T, c, r, SMOOTH_K, budget, mask)
    cfg = TrainConfig(use_culling=True, cull_tile=T, cull_budget=budget)
    got = k7.tile_select(ro, rd, T, c, r, SMOOTH_K, budget, mask)
    tables = culled_tables(cfg, ro, rd, c, r, SMOOTH_K, mask)
    assert len(plain) == len(got) == len(tables) == 5
    for a, b, t in zip(plain, got, tables):
        assert torch.equal(a, b) and torch.equal(a, t)
    with pytest.raises(ValueError, match="unsupported device"):
        k7.launch_tile_select(ro, rd, T, c, r, SMOOTH_K, budget, mask)


def _against_cone(ro, rd, c, r, mask, budget, cones):
    """The plain tables selected against ``cones`` and the cones packed as
    K7 hands them out (launch_tile_select with_cones)."""
    from burn_raymarching_tpu_torch.ops.culling import (
        select_tile_primitives,
        selected_tables,
    )

    idx, valid = select_tile_primitives(cones, c, r, SMOOTH_K, budget,
                                        mask=mask)
    packed = torch.cat([cones.apex, cones.axis, cones.cos_half[:, None],
                        cones.origin_spread[:, None]], dim=1)
    return (idx, valid) + selected_tables(c, r, idx, valid) + (packed,)


@pytest.mark.parametrize("part", ["none", "apex", "axis", "cos_half",
                                  "origin_spread"])
def test_the_card_check_fails_a_selection_against_a_wrong_cone(part):
    """chip_smoke.k7_compare (the check of K7 on the card) passes the plain
    tables on tile_cones' cones, and fails tables that are consistent with
    a cone other than tile_cones': the slots then agree with a selection on
    that cone, and the cone gap alone fails them."""
    import chip_smoke

    ro, rd, c, r, mask, budget = _case("spread")
    cones = tile_cones(ro, rd, T)
    if part != "none":
        shift = {"apex": torch.tensor([2e-3, 0.0, 0.0]),
                 "axis": torch.tensor([0.0, 4e-3, 0.0]),
                 "cos_half": torch.tensor(-2e-4),
                 "origin_spread": torch.tensor(2e-3)}[part]
        value = getattr(cones, part) + shift
        if part == "axis":
            value = value / value.norm(dim=1, keepdim=True)
        cones = cones._replace(**{part: value})
    out = _against_cone(ro, rd, c, r, mask, budget, cones)
    cmp = chip_smoke.k7_compare(torch, ro, rd, c, r, SMOOTH_K, budget, mask,
                                out)
    assert cmp["tail_ascending"] and cmp["gathers_bitwise"]
    assert cmp["slots_apart_within_tol"] == 0
    if part == "none":
        assert cmp["bad"] == 0 and cmp["cone_max_abs_gap"] == 0.0
    else:
        assert cmp["bad"] == 1
        assert cmp["cone_max_abs_gap"] > chip_smoke.K7_CONE_TOL


def _trainer(tmp_path, device, **kw):
    """A small culled trainer at config 4's compositor (the generator's
    scene at 128², tile sampling, the warm march, K3, K6) on ``device``."""
    from burn_raymarching_tpu_torch.tools import generate
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    out = str(tmp_path / "data")
    if not os.path.exists(os.path.join(out, "cameras.json")):
        generate.main(["--out", out, "--size", "128", "--device", "cpu"])
    kw = {"width": 128, "height": 128, "batch_size": 4096,
          "use_culling": True, "cull_tile": 512, "cull_budget": 64,
          "sample_mode": "tile", "dataset_order": "morton",
          "warm_start": True, "warm_steps": 16, "init_n": 300,
          "init_layout": "cloud", "steps_per_stage": 100,
          "checkpoint_dir": "",
          "render": dataclasses.replace(RenderConfig(),
                                        softmax_sharpness=40.0,
                                        mask_sharpness=60.0), **kw}
    cfg = TrainConfig(cameras_json=os.path.join(out, "cameras.json"), **kw)
    return Trainer(cfg, build_dataset(cfg, device=device), log=lambda m: None)


def _runner(tr, graphs=True):
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer
    from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree

    padded, mask = pad_params(tr._init_params(), 512)
    fg, n_fg = tr._sample_fg
    tr.prefill_t_cache(padded, mask, 128.0)
    return ChunkRunner(
        tr.step_fn, padded, make_optimizer(tr.cfg, padded),
        lr_scale_tree(tr.cfg, 0), 0, mask, tr.dataset.packed, fg, n_fg,
        torch.Generator(device=tr.device).manual_seed(5),
        t_cache=tr.t_cache, graphs=graphs)


def test_a_culled_cpu_step_selects_through_the_plain_version(tmp_path,
                                                            monkeypatch):
    """On the CPU a culled step makes one flat selection a step, through
    tile_select, and its tables are the plain version's bitwise."""
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.train import step_body

    calls = []

    def spy(*args):
        got = k7.tile_select(*args)
        want = k7.tile_select_plain(*args)
        calls.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        return got

    monkeypatch.setattr(step_body, "tile_select", spy)
    tr = _trainer(tmp_path, "cpu", batch_size=1024, cull_tile=256,
                  warm_start=False)
    padded, mask = pad_params(tr._init_params(), 512)
    fg, n_fg = tr._sample_fg
    for step in (1, 2):
        tr.step_fn(padded, torch.Generator().manual_seed(step), 0, step,
                   mask, tr.dataset.packed, fg, n_fg)
    assert calls == [True, True]


# --- on the card ---------------------------------------------------------- #

# Live spheres of the knot cloud behind each table size (its bucket is the
# next power of two; the table is its first M rows, masked past the live).
LIVE = {16: 12, 128: 100, 2048: 1340, 8192: 5120, 51200: 51200,
        65536: 51200}


@pytest.fixture(scope="module")
def c4_rays():
    """Config 4's 32 Morton ray tiles of 512 rays (chip_smoke.c4_tiles)."""
    import chip_smoke

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    _, mask, c, r = chip_smoke.knot_cloud(torch, dev, chip_smoke.C4_INIT_N)
    args, _ = chip_smoke.c4_tiles(torch, dev, c, r, mask)
    return args[0].reshape(-1, 3), args[1].reshape(-1, 3)


def _check(ro, rd, tile, c, r, k, budget, mask) -> tuple:
    import chip_smoke

    call = (ro, rd, tile, c, r, k, budget, mask)
    out = k7.launch_tile_select(*call, with_cones=True)
    torch.cuda.synchronize()
    cmp = chip_smoke.k7_compare(torch, ro, rd, c, r, k, budget, mask, out)
    assert cmp["bad"] == 0, cmp
    assert cmp["cone_max_abs_gap"] <= chip_smoke.K7_CONE_TOL, cmp
    again = k7.launch_tile_select(*call, with_cones=True)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    return out, cmp


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [16, 256, 2048, 4096])
@pytest.mark.parametrize("m", [16, 128, 2048, 8192, 51200, 65536])
def test_cuda_kernel_matches_the_plain_selection(c4_rays, m, budget):
    """Config 4's tiles against a knot cloud of M rows, K slots."""
    import chip_smoke

    dev = c4_rays[0].device
    _, mask, c, r = chip_smoke.knot_cloud(torch, dev, LIVE[m])
    c, r, mask = (c[:m].contiguous(), r[:m].contiguous(),
                  mask[:m].contiguous())
    out, cmp = _check(*c4_rays, chip_smoke.C4_TILE, c, r, chip_smoke.C4_K,
                      budget, mask)
    assert out[0].shape == (32, min(budget, m))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_keeps_the_rule_on_the_cpu_cases(cuda_device, name):
    """The CPU tests' tiles (24 rays a tile): within the tolerance of the
    plain selection; the exact ties, masked rows and the empty tile as the
    rule says."""
    ro, rd, c, r, mask, budget = (
        x.to(cuda_device) if torch.is_tensor(x) else x for x in _case(name))
    out, _ = _check(ro, rd, T, c, r, SMOOTH_K, budget, mask)
    idx, valid, qs = nn(out[0]), nn(out[1]), nn(out[4])
    want_idx, want_valid, _ = _rule(*(x.cpu() if torch.is_tensor(x) else x
                                      for x in (ro, rd, c, r, mask, budget)))
    if name in ("overflow_ties", "empty_tile", "few_rows"):
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(valid, want_valid)
    assert np.all(qs[~valid] == np.float32(1e30))
    if mask is not None:
        assert not np.any(nn(mask)[idx[valid]] == 0)


@pytest.mark.cuda
def test_cuda_captured_launch_replays_bitwise(c4_rays):
    """A launch recorded in a CUDA graph, replayed, writes what the eager
    launch writes; smooth_k is read from device memory at replay."""
    import chip_smoke

    dev = c4_rays[0].device
    _, mask, c, r = chip_smoke.knot_cloud(torch, dev, chip_smoke.C4_INIT_N)
    k = torch.tensor([96.0], device=dev)
    call = (*c4_rays, chip_smoke.C4_TILE, c, r, k, chip_smoke.C4_BUDGET,
            mask)
    eager = [x.clone() for x in k7.launch_tile_select(*call)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = k7.launch_tile_select(*call)
    k.fill_(128.0)
    graph.replay()
    torch.cuda.synchronize()
    other = k7.launch_tile_select(*call)
    assert all(torch.equal(a, b) for a, b in zip(other, captured))
    k.fill_(96.0)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))
    assert not torch.equal(eager[1], other[1])


@pytest.mark.cuda
def test_cuda_config4_step_through_k7_matches_the_plain_selection(
        cuda_device, tmp_path, monkeypatch):
    """Two captured culled steps at config 4's compositor (K3, K6),
    their prefill and selection through K7, against the same steps with
    the plain selection: each loss rtol 1e-4, the first step's gradients
    rtol 1e-3 with atol 1e-3 of each leaf's largest entry, the parameters
    after each Adam step atol 1e-4 (tests/test_torch_culled_step.py)."""
    from burn_raymarching_tpu_torch.train import step_body

    runs = {}
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(step_body, "tile_select",
                                k7.tile_select_plain)
        before = k7.launch_tile_select.launches
        runner = _runner(_trainer(tmp_path, cuda_device))
        steps = []
        for step in (1, 2):
            runner.run(step, 1)
            torch.cuda.synchronize()
            steps.append([float(runner.loss)]
                         + [nn(p) for p in runner.params.parameters()]
                         + [nn(p.grad) for p in runner.params.parameters()])
        runner.close()
        runs[plain] = steps
        launched = k7.launch_tile_select.launches - before
        assert (launched == 0) if plain else (launched > 2)
    n = (len(runs[False][0]) - 1) // 2
    for step, (got, want) in enumerate(zip(runs[False], runs[True])):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        for a, b in zip(got[1:1 + n], want[1:1 + n]):
            np.testing.assert_allclose(a, b, atol=1e-4)
        if step == 0:
            for a, b in zip(got[1 + n:], want[1 + n:]):
                np.testing.assert_allclose(a, b, rtol=1e-3,
                                           atol=1e-3 * np.abs(b).max())


@pytest.mark.cuda
def test_cuda_captured_steps_select_through_the_kernel_alone(
        cuda_device, tmp_path, monkeypatch):
    """The prefill and captured culled steps select through K7: the plain
    flat selection is never reached on the card (it raises here), and the
    steps run and capture."""
    def plain(*args, **kw):
        raise AssertionError("the plain flat selection ran on the card")

    monkeypatch.setattr(k7, "select_tile_primitives", plain)
    before = k7.launch_tile_select.launches
    runner = _runner(_trainer(tmp_path, cuda_device))
    runner.run(1, 4)
    torch.cuda.synchronize()
    loss = float(runner.loss)
    runner.close()
    assert k7.launch_tile_select.launches - before > 2
    assert np.isfinite(loss)

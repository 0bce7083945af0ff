"""The port's bench (burn_raymarching_tpu_torch/tools/bench.py) against the
repository's bench.py, loaded by path as the oracle, at a small size: a 16²
camera tiled 4 times (1,024 rays), batch 256, 12 live primitives of 16
slots, ``SCAN_STEPS`` cut to 3. The JAX package's kernels run in interpret
mode, as its own tests run them; the port's wrappers run their plain
versions on the CPU. The JAX draws (``fold_in(key, i)`` →
``sample_batch_indices``) are injected into the port through ChunkRunner's
``idx_fn``.

Tolerances: every quantity is held to 5x the port's own float32 gap to the
same steps run in float64 (the float64 yardstick), and never below 1e-5
(relative for losses, absolute for parameters and t). Seen (port vs JAX /
float32 vs float64): parameters up to 5.7e-5 / 3.2e-5 (the light, warm),
the warm t cache 5.6e-5 / 1.4e-5, the prefilled cache on hit rays 3.2e-4 /
1.3e-4, losses 3.1e-6 relative. The ``cuda`` tests hold the captured bench
step to the same steps one at a time, bitwise, and run ``main`` at full
width on the card."""

from __future__ import annotations

import functools
import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device, nn  # noqa: F401  (a fixture)

import burn_raymarching_tpu.ops.pallas.shade_kernel as jax_shade
from burn_raymarching_tpu.config import TrainConfig as JTrainConfig
from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.data.dataset import sample_batch_indices as j_sample
from burn_raymarching_tpu.models.scene import SceneParams
from burn_raymarching_tpu.models.scene import init_scene_params as j_init
from burn_raymarching_tpu.models.scene import pad_params as j_pad
from burn_raymarching_tpu.ops.pallas.march_shade_kernel import (
    march_shade_pallas,
)
from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.models.scene import (
    PARAM_KEYS,
    params_from_numpy,
)
from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
    march_shade,
)
from burn_raymarching_tpu_torch.tools import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, VIEWS, BATCH, LIVE, SLOTS, N_FG, STEPS = 16, 4, 256, 12, 16, 300, 3
VARIANTS = ("plain", "kernel", "warm")
YARDSTICK = 5.0
FLOOR = 1e-5


@pytest.fixture(scope="module")
def jax_bench():
    """The repository's bench.py as a module (it imports only jax and
    numpy at module level)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_k1(*args, **kw):
    return march_shade_pallas(*args, interpret=True, **kw)


@pytest.fixture(scope="module")
def inputs():
    """bench.py:144-161's workload at the small size, as numpy arrays, with
    the JAX draws of the 3 steps (PRNGKey(0)) and the t cache that
    bench.py:174-181 prefills (K1 in interpret mode)."""
    rng = np.random.default_rng(0)
    p = j_init(LIVE)
    p.centers = jnp.asarray(rng.normal(0, 0.3, (LIVE, 3)), jnp.float32)
    p.radii = jnp.asarray(rng.normal(-2.0, 0.3, (LIVE, 1)), jnp.float32)
    padded, mask = j_pad(p, SLOTS)
    ro, rd = j_rays(SIZE, SIZE, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    ro, rd = jnp.tile(ro, (VIEWS, 1)), jnp.tile(rd, (VIEWS, 1))
    packed = np.array(jnp.concatenate(
        [ro, rd, jnp.clip(jnp.abs(rd), 0, 1)], axis=1))
    fg = np.arange(packed.shape[0], dtype=np.int32)
    key = jax.random.PRNGKey(0)
    idxs = [np.array(j_sample(jax.random.fold_in(key, i), packed.shape[0],
                                jnp.asarray(fg), jnp.int32(N_FG), BATCH,
                                jnp.float32(0.6))) for i in range(STEPS)]
    t_cache = []
    for s in range(0, packed.shape[0], BATCH):
        t, _ = _jax_k1(jnp.asarray(packed[s:s + BATCH, 0:3]),
                       jnp.asarray(packed[s:s + BATCH, 3:6]), padded.centers,
                       jax.nn.softplus(padded.radii) + 0.01,
                       jnp.float32(18.5), mask=mask)
        t_cache.append(np.asarray(t[:, 0]))
    return {"raw": {k: np.array(getattr(padded, k)) for k in PARAM_KEYS},
            "mask": np.array(mask), "packed": packed, "fg": fg,
            "key": key, "idxs": idxs, "t_cache": np.concatenate(t_cache)}


def _check(name: str, got, want, ref64, relative: bool = False) -> None:
    """|got − want| within YARDSTICK x |got − ref64| (the port's own
    float32 error), never below FLOOR."""
    got, want, ref64 = (np.asarray(x, np.float64) for x in (got, want, ref64))
    scale = np.abs(want).max() if relative else 1.0
    gap = np.abs(got - want).max() / scale
    tol = max(FLOOR, YARDSTICK * np.abs(got - ref64).max() / scale)
    assert gap <= tol, f"{name}: {gap:.3e} from bench.py, tolerance {tol:.3e}"


def _port_steps(inputs, variant: str, dtype=torch.float32):
    """The port's bench step, STEPS steps one at a time with the JAX draws
    injected → (per-step losses, parameters, t cache or None)."""
    cfg = TrainConfig(batch_size=BATCH, scan_unroll=1)
    step = bench.make_scan_step(cfg, None if variant == "plain"
                                else march_shade, warm=variant == "warm")
    padded = params_from_numpy(inputs["raw"], device="cpu").to(dtype)
    ds = {"packed": torch.as_tensor(inputs["packed"]).to(dtype),
          "fg_idx": torch.as_tensor(inputs["fg"]), "n_fg": N_FG}
    t_cache = (torch.as_tensor(inputs["t_cache"]).to(dtype)
               if variant == "warm" else None)
    runner = bench.make_runner(
        cfg, step, padded, torch.as_tensor(inputs["mask"]), ds, t_cache,
        idx_fn=lambda s: torch.as_tensor(inputs["idxs"][s - 1]).long())
    losses = []
    for s in range(1, STEPS + 1):
        runner.run(s, 1)
        losses.append(float(runner.loss))
    return (np.asarray(losses),
            {k: nn(getattr(runner.params, k)) for k in PARAM_KEYS},
            None if runner.t_cache is None else nn(runner.t_cache))


def test_workload_matches_bench_py(inputs):
    """make_workload builds bench.py's parameters bitwise and its rays
    within float32 rounding of the camera basis."""
    padded, mask, ds = bench.make_workload("cpu", SIZE, VIEWS, LIVE, SLOTS,
                                           N_FG)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(nn(getattr(padded, k)),
                                      inputs["raw"][k])
    np.testing.assert_array_equal(nn(mask), inputs["mask"])
    np.testing.assert_allclose(nn(ds["packed"]), inputs["packed"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(nn(ds["fg_idx"]), inputs["fg"])
    assert ds["n_fg"] == N_FG


def test_warm_t_cache_matches_bench_py(inputs):
    """The prefill (a cold 40-step K1 march over every pixel, batch-sized
    chunks) against bench.py's in interpret mode: missed rays end at the
    same cap, hit rays within the float64 yardstick."""
    padded = params_from_numpy(inputs["raw"], device="cpu")
    mask = torch.as_tensor(inputs["mask"])
    packed = torch.as_tensor(inputs["packed"])
    got = nn(bench.warm_t_cache(packed, padded, mask, BATCH))
    ref64 = nn(bench.warm_t_cache(packed.double(), padded.double(), mask,
                                  BATCH))
    want = inputs["t_cache"]
    hit = want < 10.0
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(got[~hit], want[~hit])
    _check("prefill, hit rays", got[hit], want[hit], ref64[hit])


@pytest.mark.parametrize("variant", VARIANTS)
def test_scan_step_matches_bench_py(jax_bench, inputs, monkeypatch,
                                    variant):
    """bench.py's make_scan_step (SCAN_STEPS = 3, lax.scan over the steps)
    against the port's step run by ChunkRunner one step at a time: the
    per-step losses, the parameters after 3 steps and, warm, the t cache
    the steps wrote. bench.py returns no t cache, so a callback records
    the t of each of its warm marches and the test writes them into the
    prefilled cache at the injected indices."""
    monkeypatch.setattr(jax_bench, "SCAN_STEPS", STEPS)
    monkeypatch.setattr(jax_shade, "shade_fused", functools.partial(
        jax_shade.shade_fused, interpret=True))
    marches = []

    def k1_recording(*args, **kw):
        t, normal = _jax_k1(*args, **kw)
        jax.debug.callback(lambda x: marches.append(np.asarray(x)), t,
                           ordered=True)
        return t, normal

    k1 = {"plain": None, "kernel": _jax_k1, "warm": k1_recording}[variant]
    run, tx = jax_bench.make_scan_step(
        JTrainConfig(batch_size=BATCH, scan_unroll=1), k1,
        warm=variant == "warm")
    params = SceneParams(**{k: jnp.asarray(v)
                            for k, v in inputs["raw"].items()})
    t_cache = (inputs["t_cache"] if variant == "warm"
               else np.zeros((0,), np.float32))
    out, _, losses_j = run(params, tx.init(params), inputs["key"],
                           jnp.asarray(inputs["mask"]),
                           jnp.asarray(inputs["packed"]),
                           jnp.asarray(inputs["fg"]), jnp.int32(N_FG),
                           jnp.asarray(t_cache))
    losses_j = np.asarray(losses_j)

    losses, got, cache = _port_steps(inputs, variant)
    losses64, got64, cache64 = _port_steps(inputs, variant, torch.float64)
    _check("losses", losses, losses_j, losses64, relative=True)
    for k in PARAM_KEYS:
        _check(k, got[k], np.asarray(getattr(out, k)), got64[k])
    if variant == "warm":
        assert len(marches) == STEPS
        want = inputs["t_cache"].copy()
        for idx, t in zip(inputs["idxs"], marches):
            want[idx] = t[:, 0]
        assert not np.array_equal(want, inputs["t_cache"])
        _check("t cache", cache, want, cache64)


@pytest.fixture
def short_bench(monkeypatch, tmp_path):
    """The bench cut to STEPS steps a call and one timed call, its record
    under tmp_path."""
    monkeypatch.setattr(bench, "SCAN_STEPS", STEPS)
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "RECORD", str(tmp_path / "BENCH_TORCH.json"))
    return tmp_path


def test_main_cpu_prints_one_line(capsys, short_bench):
    """``--device cpu`` runs the plain step only, at batch 2,048 on the
    full workload: one stdout line with bench.py's four keys and
    vs_baseline 1.0; the figures go to stderr and to ``--out``."""
    out = short_bench / "bench.json"
    assert bench.main(["--device", "cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "train_step_rays_per_s_per_chip"
    assert line["unit"] == "rays/s"
    assert line["value"] > 0 and line["vs_baseline"] == 1.0
    rec = json.loads(out.read_text())
    assert list(rec["variants"]) == ["plain"]
    plain = rec["variants"]["plain"]
    assert plain["graphs"] is False and plain["steps_per_call"] == STEPS
    assert plain["steps_run"] == 2 * STEPS
    assert rec["line"] == line and rec["card"] == "cpu"
    assert (rec["batch"], rec["pixels"]) == (2048, 10 * 256 * 256)


def test_cpu_writes_no_record(short_bench):
    for flag in ("--write-baseline", "--write-large-baseline"):
        with pytest.raises(SystemExit):
            bench.main(["--device", "cpu", flag])
    assert not os.path.exists(bench.RECORD)


def test_line_is_printed_before_the_flagship(capsys, short_bench,
                                             monkeypatch):
    """On the card path (forced here: a device that reports "cuda", the
    variants' figures and the card's name stubbed) the JSON line is on
    stdout before the flagship runs, as bench.py prints its line before
    its large-scene guard: a flagship that raises (a non-finite loss, out
    of memory) loses only its own figures. Exactly one line, with the
    measured step's figure, and the flagship's exception still
    propagates."""
    from burn_raymarching_tpu_torch.utils import device

    rates = {"plain": 1.0e6, "kernel": 4.0e6, "warm": 8.0e6}
    monkeypatch.setattr(device, "resolve_device",
                        lambda name: torch.device("cuda"))
    monkeypatch.setattr(bench, "card", lambda: CARD)
    monkeypatch.setattr(bench, "make_workload", lambda dev: (
        None, None, {"packed": torch.zeros((4, 9))}))
    monkeypatch.setattr(bench, "run_variant", lambda cfg, name, *a, **kw: {
        "rays_per_s": rates[name], "wall_ms_per_step": 1.0})

    def flagship(**kw):
        raise FloatingPointError("non-finite loss at step 7")

    monkeypatch.setattr(bench, "large_flagship", flagship)
    with pytest.raises(FloatingPointError):
        bench.main(["--out", str(short_bench / "bench.json")])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {
        "metric": "train_step_rays_per_s_per_chip", "value": 8.0e6,
        "unit": "rays/s", "vs_baseline": 8.0}


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("key,recorded_on,value,code", [
    ("step", CARD, 89.0, 2),
    ("step", CARD, 91.0, 0),
    ("large", CARD, 89.9, 2),
    ("step", "NVIDIA H100 80GB HBM3, 500.00 W", 10.0, 0),
    ("step", None, 10.0, 0)])
def test_regression_guard(tmp_path, capsys, key, recorded_on, value, code):
    """Against a temporary record of 100 rays/s: below 90% on the same
    card exits 2; a record from another card (name or power limit) or no
    record skips the guard with its reason."""
    path = str(tmp_path / "BENCH_TORCH.json")
    if recorded_on is not None:
        bench.write_record(path, {key: {"rays_per_s": 100.0,
                                        "ms_per_step": 1.0}},
                           recorded_on, "abc1234")
        rec = bench.load_record(path)[key]
        assert rec["card"] == recorded_on and rec["commit"] == "abc1234"
        assert rec["torch"] == torch.__version__
    assert bench.check_regression(value, CARD, path, key) == code
    err = capsys.readouterr().err
    if recorded_on != CARD:
        assert "skipped" in err
    else:
        assert ("REGRESSION" in err) == (code == 2)


def test_write_record_keeps_the_other_entry(tmp_path):
    path = str(tmp_path / "BENCH_TORCH.json")
    bench.write_record(path, {"step": {"rays_per_s": 1.0}}, CARD, "a")
    bench.write_record(path, {"large": {"rays_per_s": 2.0}}, CARD, "b")
    rec = bench.load_record(path)
    assert rec["step"]["commit"] == "a" and rec["large"]["commit"] == "b"


def test_commit_names_no_commit_outside_a_checkout(tmp_path, monkeypatch):
    """A copy of the tree that is not a git checkout of its own (a ``git
    archive`` copy, even one unpacked inside another checkout) names no
    commit in the record."""
    monkeypatch.setattr(bench, "ROOT", str(tmp_path))
    assert bench._commit() == "unknown"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("kernel", "warm"))
def test_cuda_captured_bench_step_matches_one_at_a_time(cuda_device,
                                                        variant):
    """8 steps of the bench step (batch 4,096, 100 live of 128 slots)
    replayed from captured graphs of 4 steps, and one step at a time, from
    the same start and seed: parameters, t cache, last loss and the
    generator's state bitwise equal; again after the bench's reset to the
    start with another seed (tools/bench_large.time_chunk's path)."""
    gaps = bench.replay_matches_steps(variant, cuda_device, batch=4096,
                                      size=64)
    assert gaps == {"first": 0.0, "reset": 0.0}, gaps


@pytest.mark.cuda
def test_cuda_main_beats_the_plain_step(cuda_device, tmp_path,
                                       monkeypatch):
    """``main`` at full width on the card (no record: the guards skip):
    one stdout line, the hand kernels' best step faster than the plain
    one, the three variants and the flagship in ``--out``."""
    monkeypatch.setattr(bench, "RECORD", str(tmp_path / "none.json"))
    out = tmp_path / "bench.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = bench.main(["--out", str(out)])
    assert code == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] > 0 and line["vs_baseline"] > 1.0
    rec = json.loads(out.read_text())
    assert list(rec["variants"]) == list(VARIANTS)
    assert rec["large"]["graphs"] is True
    assert rec["large"]["host_launches_per_step"] <= 3.0

"""The entry forward and the multi-card dry run
(burn_raymarching_tpu_torch/tools/dryrun_multichip.py) against the
repository's __graft_entry__.py.

* (i) ``entry``'s forward against the JAX ``__graft_entry__.entry()``
  function on the same parameters and rays, at a 32 x 32 camera (the JAX
  entry's 128 x 128 compiles slowly on the CPU): its own init, and random
  weights from a seed carried across with ``params_from_numpy``. Held to
  5x the port's own float32 gap to the same forward in float64, never
  below 1e-5 (seen: 2.0e-5 from JAX, 1.5e-5 from float64).
* (ii) the mesh rule of __graft_entry__.py:59-61 for n = 1..8.
* (iii) parts (a) and (b), the first sharded step's loss on 2 gloo ranks
  at meshes 1 x 2 and 2 x 1, against the JAX sharded step on the forced
  8 CPU devices (tests/conftest.py) with the same inputs, the port's
  schedule of step 1 passed as the JAX step's anneals and the same batch
  draws injected into both samplers, as tests/test_torch_sharded_chunk.py
  injects them. rtol 1e-5 (seen: 1.7e-6).
* (iv) the whole dry run through ``main`` on 2 and 4 gloo CPU ranks.
* (v) ``--backend nccl`` refused with fewer cards than ranks.
* the full-width slice's code path at a tiny cut on 2 gloo CPU ranks.
* (vi, ``cuda``) ``--n 1`` on the card: every part's steps replay
  captured graphs and K3 is launched.
"""

from __future__ import annotations

import importlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (cuda_device: a fixture)
    cuda_device,
    jax_params,
    pad_raw,
    random_raw_params,
)

from burn_raymarching_tpu_torch.models.scene import (
    PARAM_KEYS,
    params_from_numpy,
    scene_forward,
)
from burn_raymarching_tpu_torch.tools import dryrun_multichip as dm
from burn_raymarching_tpu_torch.train.step_body import schedule_for_step

SIZE = 32
YARDSTICK, FLOOR = 5.0, 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def bounded_ranks(monkeypatch):
    """Spawned ranks that hang fail the test within minutes (the tool's
    own bound is half an hour), well inside the suite's time limit."""
    monkeypatch.setattr(dm, "JOIN_TIMEOUT_S", 300.0)


@pytest.fixture(scope="module")
def graft():
    return importlib.import_module("__graft_entry__")


# --- (i) the entry forward ------------------------------------------------ #

@pytest.mark.parametrize("weights", ["entry", "random"])
def test_entry_forward_matches_graft_entry(graft, weights):
    """The port's entry (a 32 x 32 camera) against the JAX entry's
    function: the same 128-slot table and mask (the entry's own init,
    which the JAX entry builds too, or random weights from a seed), the
    same rays, smooth_k 32."""
    from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays

    j_fn, (j_params, _, _, j_k, j_mask) = graft.entry()
    fn, (params, ro, rd, k, mask) = dm.entry("cpu", size=SIZE)
    assert float(j_k) == k == 32.0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    if weights == "entry":
        for key in PARAM_KEYS:
            np.testing.assert_array_equal(
                getattr(params, key).detach().numpy(),
                np.asarray(getattr(j_params, key)), err_msg=key)
    else:
        raw = pad_raw(random_raw_params(11, dm.ENTRY_LIVE),
                      dm.ENTRY_SLOTS - dm.ENTRY_LIVE)
        params = params_from_numpy(raw, device="cpu")
        j_params = jax_params(raw)
    # The reduced camera is the JAX rig's at 32 x 32 (within one ulp).
    jro, jrd = j_rays(SIZE, SIZE, dm.EYE, dm.TARGET, dm.FOV)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6)

    want = np.asarray(jax.jit(j_fn)(j_params, jnp.asarray(ro.numpy()),
                                    jnp.asarray(rd.numpy()), j_k, j_mask))
    with torch.no_grad():
        got = fn(params, ro, rd, k, mask).numpy()
        p64 = types.SimpleNamespace(**{
            key: getattr(params, key).detach().double() for key in PARAM_KEYS})
        ref64 = scene_forward(p64, ro.double(), rd.double(), k,
                              mask=mask).numpy()
    assert got.shape == (SIZE * SIZE, 3) and np.isfinite(got).all()
    gap = np.abs(got - want).max()
    tol = max(FLOOR, YARDSTICK * np.abs(got - ref64).max())
    assert gap <= tol, f"{gap:.3e} from the JAX entry, tolerance {tol:.3e}"


def test_entry_default_is_the_flagship_shape():
    """At its default size the entry forward is the JAX entry's: 16,384
    rays against 128 slots (built here, not run)."""
    _, (params, ro, rd, _, mask) = dm.entry("cpu")
    assert ro.shape == rd.shape == (16384, 3)
    assert params.n == mask.shape[0] == 128 and int(mask.sum()) == 100


# --- (ii) the mesh rule --------------------------------------------------- #

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_rule_is_the_jax_dry_runs(n):
    model = 2 if n % 2 == 0 and n >= 2 else 1      # __graft_entry__.py:60
    assert dm.mesh_shape(n) == (n // model, model)
    meshes = dm.c4_meshes(n)
    assert meshes[0] == (n, 1) and all(d * m == n for d, m in meshes)
    assert len(meshes) == (2 if n % 2 == 0 else 1)


# --- (iii) parts (a) and (b) against the JAX sharded step ----------------- #

MESHES = [(1, 2), (2, 1)]


@pytest.fixture(scope="module")
def port_losses():
    """Parts (a) and (b) on 2 gloo ranks per mesh with draws injected →
    {mesh: (draws, per-rank {"dense", "culled"} losses)}."""
    rng = np.random.default_rng(5)
    out = {}
    for data, model in MESHES:
        draws = [rng.integers(0, 256, 16).astype(np.int32)
                 for _ in range(data)]
        out[(data, model)] = (draws, dm.spawn(
            2, dm.tiny_losses, data, model, draws, device="cpu",
            backend="gloo", timeout=300.0))
    return out


def _jax_loss(data: int, model: int, culled: bool, draws, monkeypatch
              ) -> float:
    """The JAX package's sharded step (what __graft_entry__.py:64-100
    runs) on a (data, model) mesh of the CPU devices, on the dry run's
    inputs, with the port's schedule of step 1 of stage 0 as its anneals
    and its sampler returning ``draws[d]`` for data shard d."""
    import burn_raymarching_tpu.parallel.train_step as jts
    from burn_raymarching_tpu.config import TrainConfig as JTrainConfig
    from burn_raymarching_tpu.parallel.mesh import make_mesh as j_mesh
    from burn_raymarching_tpu.train.optimizer import make_optimizer as j_opt

    padded, mask, packed, fg, n_fg = dm.tiny_inputs("cpu")
    cfg = dm.tiny_config(data, culled)
    progress, smooth_k, uniform, lr = schedule_for_step(cfg, 0, 1)
    kw = dict(use_culling=True, cull_tile=8, cull_budget=4) if culled else {}
    jcfg = JTrainConfig(batch_size=16 * data, **kw)
    key = jax.random.PRNGKey(1 if culled else 0)
    keys = jnp.stack([jax.random.fold_in(key, d) for d in range(data)])
    rows = jnp.asarray(np.stack(draws))

    def injected(k, *args, **kwargs):
        return rows[jnp.argmax(jnp.all(keys == k[None], axis=1))]

    monkeypatch.setattr(jts, "sample_batch_indices", injected)
    mesh = j_mesh(data, model, devices=jax.devices()[:data * model])
    tx = j_opt(jcfg)
    raw = {k: getattr(padded, k).detach().numpy() for k in PARAM_KEYS}
    p_sh = jts.shard_params(jax_params(raw), mesh, model > 1)
    pk = packed.numpy()
    _, _, loss = jts.make_sharded_train_step(jcfg, mesh, tx)(
        p_sh, tx.init(p_sh), key, jnp.asarray(mask.numpy()),
        jnp.asarray(pk[:, 0:3]), jnp.asarray(pk[:, 3:6]),
        jnp.asarray(pk[:, 6:9]), jnp.asarray(fg.numpy()), jnp.int32(n_fg),
        jnp.float32(progress), jnp.float32(smooth_k), jnp.float32(uniform),
        jnp.float32(lr))
    return float(loss)


def test_tiny_inputs_are_the_graft_entrys():
    """The dry run's tiny inputs are __graft_entry__.py:68-78's."""
    from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
    from burn_raymarching_tpu.models.scene import init_scene_params as j_init
    from burn_raymarching_tpu.models.scene import pad_params as j_pad

    padded, mask, packed, fg, n_fg = dm.tiny_inputs("cpu")
    j_padded, j_mask = j_pad(j_init(7), 8)
    for key in PARAM_KEYS:
        np.testing.assert_array_equal(getattr(padded, key).detach().numpy(),
                                      np.asarray(getattr(j_padded, key)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    ro, rd = j_rays(16, 16, dm.EYE, dm.TARGET, dm.FOV)
    tgt = jnp.clip(jnp.abs(jnp.sin(jnp.arange(256 * 3, dtype=jnp.float32)))
                   .reshape(256, 3), 0, 1)
    np.testing.assert_allclose(packed.numpy(), np.concatenate(
        [np.asarray(ro), np.asarray(rd), np.asarray(tgt)], axis=1),
        atol=1e-6)
    np.testing.assert_array_equal(fg.numpy(), np.arange(256))
    assert n_fg == 128


@pytest.mark.parametrize("part", ["dense", "culled"])
@pytest.mark.parametrize("data,model", MESHES)
def test_first_step_loss_matches_the_jax_sharded_step(port_losses,
                                                      monkeypatch, part,
                                                      data, model):
    draws, ranks = port_losses[(data, model)]
    # The loss is replicated: every rank holds the same value.
    assert len({r[part] for r in ranks}) == 1
    want = _jax_loss(data, model, part == "culled", draws, monkeypatch)
    np.testing.assert_allclose(ranks[0][part], want, rtol=LOSS_RTOL)


# --- (iv) the whole dry run on gloo CPU ranks ----------------------------- #

@pytest.mark.parametrize("n", [2, 4])
def test_dry_run_on_gloo_cpu_ranks(capsys, n):
    """``main`` spawns n gloo ranks on the CPU: one summary line; the JAX
    rule's mesh (model 2, so the union part runs); finite losses; K3's
    wrapper (its plain version on the CPU) called on parts (d) and (e)
    and on no other part; no kernel launched; every step one at a time."""
    assert dm.main(["--n", str(n), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    s = json.loads(lines[0])
    data, model = dm.mesh_shape(n)
    assert model == 2
    assert s["dryrun_multichip"] == n and s["backend"] == "gloo"
    assert s["mesh"] == {"data": data, "model": model}
    assert s["device"] == "cpu"
    assert np.isfinite(s["loss"]) and np.isfinite(s["culled_loss"])
    assert s["driver_n"] > 0
    assert s["kernel_in_sharded_step"] and s["union_kernel_msharded"]
    assert list(s["parts"]) == list(dm.PARTS)
    for name, part in s["parts"].items():
        assert part["graphs"] == [False] * n
        assert part["launches"] == {} and part["k3_launches"] == 0
        assert (part["k3_calls"] > 0) == (name in ("kernel", "union")), name
        assert part["seconds"] > 0


def test_dry_run_parts_subset_on_gloo_cpu_ranks():
    """``parts`` runs the named parts alone, in the dry run's order: (d)
    and (e) on 2 gloo CPU ranks (the union part at model 2), K3's wrapper
    called in both; the figures of the parts that did not run are None;
    an unknown part is refused before any rank starts."""
    s = dm.dryrun_multichip(2, "cpu", "gloo", ("union", "kernel"))
    assert list(s["parts"]) == ["kernel", "union"]
    assert s["loss"] is None and s["culled_loss"] is None
    assert s["driver_n"] is None
    assert s["kernel_in_sharded_step"] and s["union_kernel_msharded"]
    for part in s["parts"].values():
        assert part["k3_calls"] > 0 and part["graphs"] == [False, False]
    with pytest.raises(ValueError, match="unknown parts"):
        dm.dryrun_multichip(2, "cpu", "gloo", ("kernel", "everything"))


# --- (v) NCCL never falls back ------------------------------------------- #

@pytest.mark.parametrize("argv,needs", [
    (["--n", "2", "--backend", "nccl"], "needs 2 cards, this machine has 1"),
    (["--n", "2", "--device", "cpu", "--backend", "nccl"], "--device cpu")])
def test_nccl_with_too_few_cards_is_refused(capsys, monkeypatch, argv,
                                            needs):
    """NCCL takes one card per rank: with one card for two ranks (or no
    card at all) ``main`` names the numbers and exits nonzero, and no rank
    is started: nothing runs over gloo instead."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    started = []
    monkeypatch.setattr(dm, "spawn", lambda *a, **kw: started.append(a))
    assert dm.main(argv) != 0
    assert needs in capsys.readouterr().err
    assert started == []


# --- the full-width slice, at a tiny cut ---------------------------------- #

def test_c4_slice_tiny_cut_on_gloo_cpu_ranks():
    """``c4_slice`` (the ``--width c4`` path) on 2 gloo CPU ranks at a tiny
    cut of config 4's recipe (2 views at 32², 256 spheres, budget 64,
    batch 1,024, 4 steps, 3 timed): one record per mesh (2 x 1, then
    1 x 2), each rank's K3 wrapper called (``c4_mesh`` raises otherwise),
    finite losses, a positive rate; no device figure off the card."""
    recipe = ("--views", "2", "--size", "32", "--gt-n", "50", "--init-n",
              "256", "--cull-budget", "64", "--batch", "1024",
              "--merge-cell", "0.04")
    recs = dm.c4_slice(2, None, "cpu", None, recipe=recipe, steps=4,
                       steady=3)
    assert [r["mesh"] for r in recs] == [[2, 1], [1, 2]]
    for rec in recs:
        assert rec["device"] == "cpu" and rec["backend"] == "gloo"
        assert rec["batch"] == 1024 and rec["rays_per_s"] > 0
        for rank in rec["ranks"]:
            assert rank["graphs"] is False and np.isfinite(rank["loss"])
            assert rank["n_live"] == 256
            for key in ("device_busy_ms_per_step", "k3_ms_per_step",
                        "nccl_ms_per_step", "peak_memory_gb"):
                assert rank[key] is None, key


# --- (vi) on the card ----------------------------------------------------- #

@pytest.mark.cuda
def test_cuda_dry_run_one_card(cuda_device, capsys):
    """``--n 1`` over NCCL on the card: every part's steps replay captured
    graphs, and K3 is launched on part (d)."""
    assert dm.main(["--n", "1"]) == 0
    s = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert s["backend"] == "nccl" and s["mesh"] == {"data": 1, "model": 1}
    assert all(p["graphs"] == [True] for p in s["parts"].values())
    assert s["parts"]["kernel"]["k3_launches"] > 0
    assert np.isfinite(s["loss"]) and np.isfinite(s["culled_loss"])

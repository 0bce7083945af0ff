"""The chunk runner (burn_raymarching_tpu_torch/train/chunk.py, loop.py)
against the JAX package's chunked Trainer: the chunk resolution of
``Trainer._chunk``, the in-graph schedule bit for bit, the sampler's pool
sizes, Adam with tensor learning rates against optax, and run_stage's
chunk cadence. The ``cuda`` tests show that K1, K2 and K3 read smooth_k
from device memory when they run (a replay after the scalar changes equals
a fresh launch at the new value, bitwise) and hold a captured 100-step
chunk against the plain per-step loop."""

from __future__ import annotations

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (cuda_device is a fixture)
    cuda_device,
    jax_params,
    nn,
    random_raw_params,
)

from burn_raymarching_tpu.config import TrainConfig as JTrainConfig
from burn_raymarching_tpu.data.dataset import RayDataset as JRayDataset
from burn_raymarching_tpu.data.dataset import (
    sample_batch_indices as j_sample,
)
from burn_raymarching_tpu.parallel.distributed import (
    DistributedTrainer as JDistributedTrainer,
)
from burn_raymarching_tpu.train.loop import Trainer as JTrainer
from burn_raymarching_tpu.train.optimizer import make_optimizer as j_opt
from burn_raymarching_tpu.train.step_body import schedule_for_step as j_sched
from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.data.dataset import (
    RayDataset,
    sample_batch_indices,
    uniform_count,
)
from burn_raymarching_tpu_torch.models.scene import (
    PARAM_KEYS,
    params_from_numpy,
)
from burn_raymarching_tpu_torch.parallel.distributed import (
    DistributedTrainer,
)
from burn_raymarching_tpu_torch.parallel.train_step import replays_graphs
from burn_raymarching_tpu_torch.train.loop import Trainer
from burn_raymarching_tpu_torch.train.optimizer import (
    make_optimizer,
    set_group_lrs,
)
from burn_raymarching_tpu_torch.train.step_body import (
    device_schedule,
    sample_step_indices,
)

# The schedules of config 1 (5 x 700, the defaults) and config 4 (3 x 1000,
# base LR 0.02, k fixed at 128; tools/run_c5.build_config).
SCHEDULES = {
    "config1": dict(),
    "config4": dict(stages=3, steps_per_stage=1000, base_lr=0.02,
                    min_smooth_k=128.0, max_smooth_k=128.0),
}


def _rays(size: int = 32):
    ro, rd = create_camera_rays(size, size, [0.0, 0.5, -2.5], [0, 0, 0],
                                50.0, device="cpu")
    return ro.numpy(), rd.numpy(), np.clip(np.abs(rd.numpy()), 0, 1)


# --- chunk resolution ---------------------------------------------------- #

@pytest.mark.parametrize("steps,spc,want", [
    (700, 0, 100), (1000, 0, 100), (40, 0, 40), (701, 0, 1), (700, 70, 70),
    (700, 3, 1)])
def test_chunk_resolution_matches_jax(steps, spc, want):
    """The single-card rows of tests/test_distributed.py's
    test_auto_steps_per_call_targets: both Trainers resolve the same
    chunk."""
    ro, rd, tgt = _rays()
    kw = dict(batch_size=64, use_pallas=False, checkpoint_dir=None,
              steps_per_stage=steps, steps_per_call=spc)
    got = Trainer(TrainConfig(**kw), RayDataset(ro, rd, tgt, device="cpu"),
                  log=lambda s: None)._chunk
    jax_chunk = JTrainer(JTrainConfig(**kw), JRayDataset(ro, rd, tgt),
                         log=lambda s: None)._chunk
    assert got == jax_chunk == want


@pytest.mark.parametrize("steps,spc,want", [
    (700, 0, 350), (1000, 0, 250), (700, 100, 100)])
def test_sharded_chunk_target_matches_jax(steps, spc, want):
    """The sharded rows: DistributedTrainer's auto target is the JAX
    package's 350, resolved by the same rule (a stub carries the config,
    since a DistributedTrainer needs a process group)."""
    assert (DistributedTrainer._chunk_target(None)
            == JDistributedTrainer._chunk_target(None) == 350)
    kw = dict(steps_per_stage=steps, steps_per_call=spc)
    got = Trainer._resolve_chunk(types.SimpleNamespace(
        cfg=TrainConfig(**kw), _chunk_target=lambda: 350))
    jax_chunk = JTrainer._resolve_chunk(types.SimpleNamespace(
        cfg=JTrainConfig(**kw), _chunk_target=lambda: 350))
    assert got == jax_chunk == want


def _axes_of(*backends):
    """Stand-ins for mesh axes that carry only a backend (a real Axis
    needs a process group)."""
    return [types.SimpleNamespace(backend=b) for b in backends]


def test_distributed_trainer_steps_one_at_a_time():
    """On the CPU the sharded steps run one at a time (gloo, by the
    backend rule of parallel/train_step.replays_graphs), and the
    single-card Trainer captures on a CUDA dataset only."""
    assert replays_graphs(torch.device("cpu"),
                          _axes_of("gloo", "gloo")) is False
    ro, rd, tgt = _rays(8)
    tr = Trainer(TrainConfig(batch_size=16, use_pallas=False),
                 RayDataset(ro, rd, tgt, device="cpu"), log=lambda s: None)
    assert tr._replays_graphs() is False


@pytest.mark.parametrize("device,backends,graphs", [
    ("cpu", ("gloo", "gloo"), False),
    ("cuda", ("gloo", "gloo"), False),
    ("cuda", ("nccl", "gloo"), False),
    ("cpu", ("nccl", "nccl"), False),
    ("cuda", ("nccl", "nccl"), True)])
def test_replays_graphs_rule(device, backends, graphs):
    """The backend rule: the sharded steps replay captured graphs on a
    CUDA dataset whose mesh axes all run NCCL, and run one at a time over
    gloo (the CPU; ranks sharing a card), whose host staging a graph
    cannot record. DistributedTrainer returns the decision its
    construction stored."""
    assert replays_graphs(torch.device(device), _axes_of(*backends)) is graphs
    stub = types.SimpleNamespace(_graphs=graphs)
    assert DistributedTrainer._replays_graphs(stub) is graphs


# --- the in-graph schedule ---------------------------------------------- #

def _jax_in_graph(cfg: JTrainConfig, stage: int):
    """The JAX package's schedule at every step of a stage, traced and
    compiled as its step computes it (the step index a traced int32)."""
    steps = jnp.arange(1, cfg.steps_per_stage + 1, dtype=jnp.int32)
    run = jax.jit(jax.vmap(lambda s, st: j_sched(cfg, st, s),
                           in_axes=(0, None)))
    return [np.asarray(x) for x in run(steps, jnp.int32(stage))]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_device_schedule_matches_jax_bitwise(name):
    """progress, smooth_k, uniform_ratio and the learning rate at every step
    of every stage, equal to the float32 bit."""
    kw = SCHEDULES[name]
    cfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
    for stage in range(cfg.stages):
        want = _jax_in_graph(jcfg, stage)
        steps = torch.arange(1, cfg.steps_per_stage + 1)
        got = device_schedule(cfg, stage, steps)
        for label, g, w in zip(("progress", "smooth_k", "uniform_ratio",
                                "lr"), got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(
                nn(g).view(np.uint32), w.astype(np.float32).view(np.uint32),
                err_msg=f"{name} stage {stage} {label}")


def test_device_schedule_past_the_end_holds_the_final_values():
    """polish's steps (offset past the schedule end) keep progress at 1."""
    cfg = TrainConfig()
    p, k, u, lr = device_schedule(cfg, cfg.stages - 1,
                                  torch.tensor([cfg.steps_per_stage + 1,
                                                2 * cfg.steps_per_stage]))
    assert nn(p).tolist() == [1.0, 1.0]
    assert nn(k).tolist() == [cfg.max_smooth_k] * 2
    np.testing.assert_allclose(nn(u), cfg.uniform_ratio_end, rtol=1e-7)


# --- the sampler -------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("n_fg", [0, 37, 5000])
def test_uniform_count_matches_jax_rule(name, n_fg):
    """n_uniform from the device uniform_ratio at every step of the
    schedule, against JAX's own sampler: with every fg entry -1, the
    uniform slots of its batch are the non-negative indices."""
    kw = SCHEDULES[name]
    cfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
    batch = 1024
    fg = jnp.full((8192,), -1, jnp.int32)

    def jax_n_uniform(ur):
        idx = j_sample(jax.random.PRNGKey(0), 8192, fg, jnp.int32(n_fg),
                       batch, ur)
        return jnp.sum(idx >= 0)

    run = jax.jit(jax.vmap(jax_n_uniform))
    for stage in range(cfg.stages):
        ur = _jax_in_graph(jcfg, stage)[2]
        want = np.asarray(run(jnp.asarray(ur)))
        ur_t = device_schedule(cfg, stage,
                               torch.arange(1, cfg.steps_per_stage + 1))[2]
        got = uniform_count(batch, n_fg, ur_t)
        np.testing.assert_array_equal(nn(got), want, err_msg=str(stage))


@pytest.mark.parametrize("tile", [False, True])
def test_device_ratio_sampler_draws_the_host_indices(tile):
    """The same generator gives the same indices whether uniform_ratio is
    the host float or the device tensor of the same value, at the steps
    of config 1's schedule (every 25th), pixel and tile sampling."""
    cfg = TrainConfig(cull_tile=16, sample_mode="tile" if tile else "random")
    fg = torch.as_tensor(np.random.default_rng(3).integers(0, 4096, 4096),
                         dtype=torch.int32)
    for stage in range(cfg.stages):
        for step in range(1, cfg.steps_per_stage + 1, 25):
            ur = device_schedule(cfg, stage, torch.tensor(step))[2]
            draws = [sample_step_indices(
                cfg, torch.Generator().manual_seed(step), 4096 * 16, fg,
                1500, 512, ratio) for ratio in (ur, float(ur))]
            np.testing.assert_array_equal(nn(draws[0]), nn(draws[1]))
            gen = torch.Generator().manual_seed(step)
            if not tile:
                direct = sample_batch_indices(gen, 4096 * 16, fg, 1500, 512,
                                              float(ur))
                np.testing.assert_array_equal(nn(draws[0]), nn(direct))


# --- Adam with tensor learning rates ------------------------------------ #

@pytest.mark.parametrize("mode", ["folded", "decoupled"])
def test_tensor_lr_adam_matches_optax(mode):
    """make_optimizer (fused, one learning-rate tensor per group written by
    set_group_lrs) against the JAX package's optax chain over 20 steps of
    the device schedule's rates: each step, from the same parameters, the
    updated parameters agree within 1e-6."""
    cfg = TrainConfig(weight_decay_mode=mode, weight_decay=1e-2,
                      lr_scale_centers=0.5, lr_scale_radii=0.25)
    scales = {"centers": 0.5, "colors": 1.0, "radii": 0.25,
              "light_dir": 1.0, "ambient": 1.0}
    raw = random_raw_params(7, 5)
    rng = np.random.default_rng(8)
    tx = j_opt(JTrainConfig(weight_decay_mode=mode, weight_decay=1e-2))
    pt = params_from_numpy(raw, device="cpu")
    opt = make_optimizer(cfg, pt)
    assert all(torch.is_tensor(g["lr"]) for g in opt.param_groups)
    assert all(g["fused"] for g in opt.param_groups)
    state = tx.init(jax_params(raw))
    for step in range(340, 360):      # across config 1's mid-stage drop
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in raw.items()}
        lr = device_schedule(cfg, 0, torch.tensor(step))[3]
        pj = jax_params({k: nn(getattr(pt, k)) for k in PARAM_KEYS})
        upd, state = tx.update(jax_params(g), state, pj)
        lr_j = np.asarray(lr)
        want = jax.tree.map(lambda p, u, s: p - lr_j * s * u, pj, upd,
                            jax_params({k: np.float32(scales[k])
                                        for k in raw}))
        for k in PARAM_KEYS:
            getattr(pt, k).grad = torch.as_tensor(g[k])
        set_group_lrs(opt, lr, scales)
        opt.step()
        for k in PARAM_KEYS:
            np.testing.assert_allclose(nn(getattr(pt, k)),
                                       np.asarray(getattr(want, k)),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{k} @ {step}")


def test_set_group_lrs_writes_in_place():
    """A captured step reads the groups' rate tensors: set_group_lrs never
    rebinds them."""
    cfg = TrainConfig()
    opt = make_optimizer(cfg, params_from_numpy(random_raw_params(1, 3),
                                                device="cpu"))
    before = [g["lr"] for g in opt.param_groups]
    set_group_lrs(opt, torch.tensor(0.03), {k: 2.0 for k in PARAM_KEYS})
    set_group_lrs(opt, 0.02, {k: 0.5 for k in PARAM_KEYS})
    for b, g in zip(before, opt.param_groups):
        assert g["lr"] is b and float(b) == np.float32(0.01)


# --- run_stage's chunks -------------------------------------------------- #

CADENCE = dict(batch_size=64, stages=1, steps_per_stage=12, use_pallas=False,
               checkpoint_dir=None, use_culling=True, cull_tile=16,
               cull_budget=8, cluster_repulsion=True, cull_cluster_group=8,
               warm_start=True, warm_steps=4, sample_mode="tile",
               dataset_order="morton", init_n=12, init_layout="cloud",
               weight_decay_mode="decoupled")


def _cadence_trainer(tmp_path, **kw):
    cfg = dataclasses.replace(TrainConfig(**CADENCE), **kw,
                              metrics_jsonl=str(tmp_path / "m.jsonl"))
    from burn_raymarching_tpu_torch.utils.morton import (
        multi_view_morton_permutation,
    )

    ro, rd, tgt = _rays()
    perm = multi_view_morton_permutation(32, 32, 1)
    tr = Trainer(cfg, RayDataset(ro[perm], rd[perm], tgt[perm], device="cpu"),
                 log=lambda s: None)
    seen = []
    base = tr._step_for_stage

    def recording(stage):
        fn = base(stage)

        def step_fn(*args, rep_static=None, **kwargs):
            seen.append((int(args[3]), rep_static))
            return fn(*args, rep_static=rep_static, **kwargs)

        return step_fn

    tr._step_for_stage = recording
    return tr, seen


def test_chunked_run_stage_follows_jax_cadence(tmp_path):
    """steps_per_call = 4 over 12 steps: the frozen repulsion tables are
    rebuilt before steps 1, 5 and 9 (one chunk each, as the JAX package's
    run_chunk builds them), and the loss is read once, at the last chunk
    end (no step is a multiple of 100)."""
    tr, seen = _cadence_trainer(tmp_path, steps_per_call=4)
    assert tr._chunk == 4
    params = tr._init_params()
    _, _, loss = tr.run_stage(params, 0, torch.Generator().manual_seed(0))
    assert [s for s, _ in seen] == list(range(1, 13))
    fresh = [s for i, (s, st) in enumerate(seen)
             if i == 0 or st is not seen[i - 1][1]]
    assert fresh == [1, 5, 9]
    assert len(tr.loss_history) == 1
    assert float(loss) == tr.loss_history[0]
    with pytest.raises(ValueError, match="divisible by steps_per_call"):
        tr.run_stage(params, 0, torch.Generator().manual_seed(0),
                     num_steps=6)


def test_chunk_size_does_not_change_the_steps(tmp_path):
    """Without the repulsion (whose tables are rebuilt per chunk) the chunk
    is only a read cadence: chunks of 12, 4 and 1 step train bitwise
    alike on the CPU."""
    out = []
    for spc in (12, 4, 1):
        tr, _ = _cadence_trainer(tmp_path, steps_per_call=spc,
                                 cluster_repulsion=False)
        padded, _, _ = tr.run_stage(tr._init_params(), 0,
                                    torch.Generator().manual_seed(5))
        out.append([nn(getattr(padded, k)) for k in PARAM_KEYS])
    for other in out[1:]:
        for a, b in zip(out[0], other):
            np.testing.assert_array_equal(a, b)


def test_scan_unroll_must_divide_the_chunk(tmp_path):
    tr, _ = _cadence_trainer(tmp_path, steps_per_call=4, scan_unroll=3)
    with pytest.raises(ValueError, match="scan_unroll"):
        tr.run_stage(tr._init_params(), 0, torch.Generator().manual_seed(0))


# --- on the card ---------------------------------------------------------- #

def _capture(fn):
    """Record ``fn()`` in a CUDA graph after one warm-up call on the same
    side stream → (graph, what the recorded call returned)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    return graph, out


def _k1_case(dev, n=2048, m=16, seed=0):
    rng = np.random.default_rng(seed)
    ro, rd = create_camera_rays(64, 32, [0.0, 0.3, -2.0], [0, 0, 0], 50.0,
                                device="cpu")
    c = torch.as_tensor(rng.normal(0, 0.3, (m, 3)), dtype=torch.float32)
    r = torch.as_tensor(0.1 + 0.1 * rng.random((m, 1)), dtype=torch.float32)
    mask = torch.arange(m) < m - 3
    return [x.to(dev) for x in (ro[:n], rd[:n], c, r, mask)]


@pytest.mark.cuda
def test_cuda_k1_replay_reads_smooth_k(cuda_device):
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade,
    )

    ro, rd, c, r, mask = _k1_case(cuda_device)
    k = torch.full((), 5.0, device=cuda_device)
    graph, (t_g, n_g) = _capture(
        lambda: march_shade(ro, rd, c, r, k, mask=mask))
    graph.replay()
    t_5 = t_g.clone()
    k.fill_(21.5)
    graph.replay()
    t_f, n_f = march_shade(ro, rd, c, r, 21.5, mask=mask)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(nn(t_g), nn(t_f))
    np.testing.assert_array_equal(nn(n_g), nn(n_f))
    assert not torch.equal(t_5, t_f)


@pytest.mark.cuda
def test_cuda_k3_replay_reads_smooth_k(cuda_device):
    from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
        culled_march_normals,
    )

    ro, rd, c, r, _ = _k1_case(cuda_device, n=2048, m=64)
    b = 4
    ro3, rd3 = ro.reshape(b, -1, 3), rd.reshape(b, -1, 3)
    cs = c[None].expand(b, -1, -1).contiguous()
    rs = r.reshape(1, -1).expand(b, -1).contiguous()
    qs = torch.sum(cs * cs, dim=2)
    qs[:, -5:] = 1e30
    k = torch.full((), 8.0, device=cuda_device)
    graph, (t_g, n_g) = _capture(
        lambda: culled_march_normals(ro3, rd3, cs, rs, qs, k, num_steps=40))
    graph.replay()
    t_8 = t_g.clone()
    k.fill_(128.0)
    graph.replay()
    t_f, n_f = culled_march_normals(ro3, rd3, cs, rs, qs, 128.0,
                                    num_steps=40)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(nn(t_g), nn(t_f))
    np.testing.assert_array_equal(nn(n_g), nn(n_f))
    assert not torch.equal(t_8, t_f)


@pytest.mark.cuda
def test_cuda_k2_replay_reads_smooth_k(cuda_device):
    """K2's forward and backward (autograd recorded with them)."""
    from burn_raymarching_tpu_torch.models.scene import activate
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade,
    )
    from burn_raymarching_tpu_torch.ops.cuda.shade_kernel import shade_fused

    ro, rd, _, _, mask = _k1_case(cuda_device)
    p = params_from_numpy(random_raw_params(3, 16), device=cuda_device)
    cot = torch.as_tensor(np.random.default_rng(4).normal(
        0, 1, (ro.shape[0], 3)), dtype=torch.float32, device=cuda_device)

    def fwd_bwd(k):
        c, col, r, ld, amb = activate(p)
        t, normal = march_shade(ro, rd, c.detach(), r.detach(), 12.0,
                                mask=mask)
        out = shade_fused(ro, rd, t, normal, c, r, col, ld, amb, k,
                          mask=mask)
        grads = torch.autograd.grad(torch.sum(out * cot), list(
            p.parameters()))
        return (out, *grads)

    k = torch.full((), 5.0, device=cuda_device)
    graph, got = _capture(lambda: fwd_bwd(k))
    graph.replay()
    at_5 = [x.clone() for x in got]
    k.fill_(30.0)
    graph.replay()
    fresh = fwd_bwd(30.0)
    torch.cuda.synchronize()
    for g, f in zip(got, fresh):
        np.testing.assert_array_equal(nn(g), nn(f))
    assert not torch.equal(at_5[0], fresh[0])
    assert not torch.equal(at_5[1], fresh[1])


@pytest.mark.cuda
def test_cuda_captured_chunk_matches_the_plain_loop(cuda_device, tmp_path):
    """A tiny config-1 stage (K1 + K2) of 100 steps, once replayed from a
    graph of one step and once one step at a time, from the same state
    and generator: the generators end in the same state and the
    parameters and the last loss bitwise equal (K1, K2 and the rest of
    the dense step have no atomics). Each kernel of the graph is counted
    once per replay, and once for the warm-up step."""
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
    from burn_raymarching_tpu_torch.ops.cuda import shade_kernel as k2
    from burn_raymarching_tpu_torch.tools import generate
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.loop import build_dataset
    from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree

    out = str(tmp_path / "data")
    generate.main(["--out", out, "--size", "32", "--device", "cpu"])
    cfg = TrainConfig(cameras_json=os.path.join(out, "cameras.json"),
                      width=32, height=32, batch_size=1024,
                      steps_per_stage=100)
    tr = Trainer(cfg, build_dataset(cfg, device=cuda_device),
                 log=lambda s: None)
    runs = []
    for graphs in (True, False):
        padded, mask = pad_params(tr._init_params(), 8)
        fg, n_fg = tr._sample_fg
        runner = ChunkRunner(
            tr.step_fn, padded, make_optimizer(cfg, padded),
            lr_scale_tree(cfg, 0), 0, mask, tr.dataset.packed, fg, n_fg,
            torch.Generator(device=cuda_device).manual_seed(9),
            graphs=graphs)
        before = k1.march_shade.launches, k2.launch_shade_bwd.launches
        runner.run(1, 100)
        torch.cuda.synchronize()
        after = k1.march_shade.launches, k2.launch_shade_bwd.launches
        # The graph's warm-up step launched them once more.
        assert after == tuple(b + 100 + graphs for b in before)
        runs.append(([nn(getattr(padded, k)) for k in PARAM_KEYS],
                     runner.generator.get_state(), float(runner.loss)))
        runner.close()
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2]

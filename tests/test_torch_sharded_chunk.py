"""The sharded chunk runner (parallel/train_step.make_sharded_chunk_runner,
the port of the JAX package's function of that name) and the sharded step
recorded in a CUDA graph.

On the CPU (gloo ranks, tests/torch_dist.py) the runner's steps run one at
a time by the backend rule, and are bitwise the sharded step called once
per step. The ``cuda`` tests hold what a graph records against what runs
eagerly, bitwise:

* (a) the collectives (psum, pmax, all_gather, all_to_all, mean_grads) on
  an NCCL world of one, recorded and replayed on new inputs;
* (b) the step body built with explicit 1-wide axes on that world, so
  that the recorded step holds real NCCL calls: a tiny config-4 cut with
  both axes (K3 on the union table, all-to-all, all-gathers, psum and
  pmax in the loss and the renderer, the data-axis all-reduce) and a tiny
  config-1 cut with the data axis only (K1, K2, the all-reduce). It is
  also held against the step without axes: bitwise where the 1-wide
  branch does the same arithmetic (the data axis: its all-reduce of one
  rank and its division by 1 are exact), at the sharding tests'
  tolerances where it does not (the model axis: the sharded softmax and
  soft-min are written as max, exp, psum and divide, and the pvary'd ray
  point sums its gradient in another order);
* (c) the 1 x 1 DistributedTrainer, captured, against the same trainer
  forced to one step at a time by a subclass's ``_replays_graphs``;
* (d) the same on two NCCL ranks, one per card, at 1 x 2 and 2 x 1
  (skips with fewer than two cards).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist

from torch_dist import C1_CUT, C4_CUT, morton_rays

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS

# --- the CPU: gloo ranks ------------------------------------------------- #

@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)])
def test_sharded_chunk_runner_matches_the_sharded_step(tmp_path, data,
                                                       model):
    """make_sharded_chunk_runner's runner, 6 steps of a stage on 2 gloo
    ranks (the model-sharded case marches on the union table through the
    K3 wrapper), against 6 calls of make_sharded_train_step from the same
    stage start and generator: the runner runs them one at a time (gloo)
    and ends bitwise where the calls end, with the same loss, t cache and
    generator state."""
    res = torch_dist.run_ranks(
        tmp_path, data * model, torch_dist.sharded_chunk_vs_steps, data,
        model, C4_CUT, morton_rays(), 6)
    for r in res:
        got, want = r["runner"], r["steps"]
        assert got["graphs"] is False
        for k in PARAM_KEYS:
            np.testing.assert_array_equal(got["params"][k],
                                          want["params"][k], err_msg=k)
        assert got["loss"] == want["loss"]
        np.testing.assert_array_equal(got["t_cache"], want["t_cache"])
        np.testing.assert_array_equal(got["generator"], want["generator"])
    # Every data replica took the same step; the model ranks hold their
    # own rows.
    if data == 2:
        for k in PARAM_KEYS:
            np.testing.assert_array_equal(res[0]["runner"]["params"][k],
                                          res[1]["runner"]["params"][k])


def _jax_chunks(cfg_kw, data, model, raw, mask, packed, t_init, draws,
                stage, chunk, monkeypatch):
    """The JAX package's make_sharded_chunk_runner on a (data, model) mesh
    of the conftest's CPU devices, ``len(draws)`` steps of ``stage`` in
    chunks of ``chunk`` (a fresh key per chunk), its sampler patched to
    return ``draws[s][d]`` where the step's key (the chunk key folded with
    the step, then with d on a data axis wider than 1) asks for step s + 1
    of data shard d, and its schedule_for_step patched to report what each
    step computes → (the loss at each chunk end, the schedule rows [step,
    progress, smooth_k, uniform_ratio, lr])."""
    import burn_raymarching_tpu.train.step_body as jsb
    from burn_raymarching_tpu.config import TrainConfig as JTrainConfig
    from burn_raymarching_tpu.models.scene import SceneParams as JParams
    from burn_raymarching_tpu.parallel.mesh import make_mesh as j_mesh
    from burn_raymarching_tpu.parallel.train_step import (
        make_sharded_chunk_runner as j_runner,
    )
    from burn_raymarching_tpu.train.optimizer import make_optimizer as j_opt

    cfg = JTrainConfig(**cfg_kw)
    mesh = j_mesh(data, model, devices=jax.devices()[:data * model])
    chunk_keys = [jax.random.PRNGKey(c) for c in range(len(draws) // chunk)]
    keys, rows = [], []
    for c, ck in enumerate(chunk_keys):
        for i in range(chunk):
            k = jax.random.fold_in(ck, i)
            for d in range(data):
                keys.append(np.asarray(jax.random.fold_in(k, d) if data > 1
                                       else k))
                rows.append(draws[c * chunk + i][d])
    keys, rows = jnp.asarray(np.stack(keys)), jnp.asarray(np.stack(rows))

    def injected(key, *args, **kwargs):
        return rows[jnp.argmax(jnp.all(keys == key[None], axis=1))]

    seen = []
    schedule = jsb.schedule_for_step

    def recording(cfg_, stage_, step):
        out = schedule(cfg_, stage_, step)
        jax.debug.callback(
            lambda *v: seen.append([int(v[0])] + [float(x) for x in v[1:]]),
            step, *out)
        return out

    monkeypatch.setattr(jsb, "sample_batch_indices", injected)
    monkeypatch.setattr(jsb, "schedule_for_step", recording)
    run = j_runner(cfg, mesh, j_opt(cfg), chunk, warm=cfg.warm_start)
    params = JParams(**{k: jnp.asarray(v) for k, v in raw.items()})
    opt_state = j_opt(cfg).init(params)
    g = cfg.cull_cluster_group
    if cfg.cluster_repulsion:
        cl_idx = jnp.arange(mask.size, dtype=jnp.int32).reshape(-1, g)
        cl_valid = jnp.asarray(mask).reshape(-1, g)
    else:
        cl_idx, cl_valid = jnp.zeros((0, 0), jnp.int32), jnp.zeros((0, 0),
                                                                   bool)
    width = len(draws[0][0])
    fgi = jnp.zeros((data, width), jnp.int32)
    t_cache = jnp.asarray(t_init if cfg.warm_start
                          else np.zeros((0,), np.float32))
    losses = []
    for c, ck in enumerate(chunk_keys):
        params, opt_state, t_cache, chunk_losses = run(
            params, opt_state, ck, jnp.asarray(mask), jnp.asarray(packed),
            fgi, jnp.zeros((data,), jnp.int32), t_cache, jnp.int32(stage),
            jnp.int32(c * chunk), cl_idx, cl_valid)
        losses.append(float(chunk_losses[-1]))
    return losses, [list(r) for r in sorted({tuple(r) for r in seen})]


@pytest.mark.parametrize("case,data,model", [("c4", 1, 2), ("c4", 2, 1),
                                             ("c1", 2, 1)])
def test_sharded_chunk_runner_matches_jax(tmp_path, monkeypatch, case, data,
                                          model):
    """The port's make_sharded_chunk_runner on 2 gloo ranks against the JAX
    package's function of that name on a 2-device CPU mesh: 8 steps of
    stage 1 in two chunks of 4, from the same table and t cache, with the
    same draws injected into both samplers (tile ids for the config-4 cut,
    pixel ids for the config-1 cut). Held: the step index and schedule
    that each step inside a chunk computes (progress, smooth_k,
    uniform_ratio, lr), equal to the float32 bit, and the loss read at
    each chunk end within rtol 1e-4 (the step tests' loss tolerance,
    tests/test_torch_culled_step.py).

    The table after Adam is not held here. On this rig the light
    direction's x gradient is float32 noise (the rig is symmetric in x),
    and Adam with eps 1e-5 turns it into a step of up to lr: after one
    step the port's own 1 x 1 and 1 x 2 runs differ by 4e-2 there. On
    top of that, the JAX package's model-sharded gradients carry the model
    size (test_torch_sharding.test_jax_sharded_gradients_carry_the_model_size),
    which changes its Adam update at eps 1e-5. The step body's tables
    after Adam are held to JAX, through the same march, in
    tests/test_torch_train.py and tests/test_torch_culled_step.py."""
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.models.scene import params_to_numpy
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from torch_parity import pad_raw

    chunk, steps, stage = 4, 8, 1
    cfg_kw = dict(CUTS[case], steps_per_call=chunk)
    arrays = morton_rays()
    ds = RayDataset(*arrays, device="cpu")
    packed = ds.packed.numpy()
    raw = params_to_numpy(Trainer(TrainConfig(**cfg_kw), ds,
                                  log=lambda s: None)._init_params())
    n = raw["centers"].shape[0]
    slots = 16
    rng = np.random.default_rng(3)
    p_local = packed.shape[0] // data
    cfg = TrainConfig(**cfg_kw)
    if cfg.sample_mode == "tile":
        draws = [[rng.integers(0, p_local // cfg.cull_tile,
                               cfg.batch_size // data // cfg.cull_tile)
                  .astype(np.int32) for _ in range(data)]
                 for _ in range(steps)]
    else:
        draws = [[rng.integers(0, p_local, cfg.batch_size // data)
                  .astype(np.int32) for _ in range(data)]
                 for _ in range(steps)]
    t_init = rng.uniform(1.0, 2.5, packed.shape[0]).astype(np.float32)

    res = torch_dist.run_ranks(
        tmp_path, data * model, torch_dist.sharded_chunks_with_draws, data,
        model, cfg_kw, arrays, raw, slots, t_init, draws, stage, chunk)
    mask = np.arange(slots) < n
    losses, schedule = _jax_chunks(
        cfg_kw, data, model, pad_raw(raw, slots - n), mask, packed, t_init,
        draws, stage, chunk, monkeypatch)

    assert [r[0] for r in schedule] == list(range(1, steps + 1))
    for r in res:
        got = np.asarray(r["schedule"], np.float32)
        np.testing.assert_array_equal(
            got.view(np.uint32), np.asarray(schedule, np.float32)
            .view(np.uint32))
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)


# --- on the card ---------------------------------------------------------- #

@pytest.fixture(scope="module")
def nccl_world():
    """A process group of one NCCL rank on card 0 (a free localhost port),
    destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and CUDA graphs have no CPU "
                    "mode)")
    import torch.distributed as dist

    from burn_raymarching_tpu_torch.parallel.mesh import init_distributed

    dev = torch.device("cuda", 0)
    init_distributed(dev)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    yield dev
    dist.destroy_process_group()


def one_wide_axes():
    """(data, model) axes of a 1 x 1 mesh on the NCCL world of one."""
    from burn_raymarching_tpu_torch.parallel.mesh import make_mesh, mesh_axis

    mesh = make_mesh(data=1, model=1)
    return mesh_axis(mesh, "data"), mesh_axis(mesh, "model")


def capture(fn):
    """Record ``fn()`` in a CUDA graph after one warm-up call on the same
    side stream (the warm-up creates the communicators) → (graph, what the
    recorded call returned)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    return graph, out


@pytest.mark.cuda
def test_cuda_nccl_collectives_replay_bitwise(nccl_world):
    """psum, pmax, all_gather, all_to_all (float and bool) and mean_grads
    on a 1-wide NCCL axis, recorded in one graph: a replay on new inputs
    (written into the recorded buffers) gives bitwise what the eager calls
    give on the same inputs, and the replay launches NCCL kernels (the
    trace's kernel names)."""
    from torch.profiler import ProfilerActivity, profile

    from burn_raymarching_tpu_torch.parallel.collectives import (
        all_gather,
        all_to_all,
        mean_grads,
        pmax,
        psum,
    )

    dev = nccl_world
    _, ax = one_wide_axes()
    x = torch.empty((8, 6, 3), device=dev)
    flag = torch.empty((8, 6), dtype=torch.bool, device=dev)
    leaves = [torch.zeros(s, device=dev, requires_grad=True)
              for s in ((5, 3), (5, 1), (3,))]
    for p in leaves:
        p.grad = torch.empty_like(p)
    extra = torch.empty((), device=dev)

    def fill(seed):
        r = np.random.default_rng(seed)
        x.copy_(torch.as_tensor(r.normal(size=x.shape), dtype=torch.float32))
        flag.copy_(torch.as_tensor(r.random(flag.shape) < 0.5))
        for p in leaves:
            p.grad.copy_(torch.as_tensor(r.normal(size=p.shape),
                                         dtype=torch.float32))
        extra.fill_(float(r.normal()))

    def collectives():
        return (psum(x, ax), pmax(x, ax), all_gather(x, ax, 1),
                all_to_all(x, ax, split_dim=0, concat_dim=1),
                all_to_all(flag, ax, split_dim=0, concat_dim=1),
                mean_grads(leaves, ax, extra))

    fill(0)
    graph, recorded = capture(collectives)
    fill(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        graph.replay()
        torch.cuda.synchronize()
    got = [t.clone() for t in recorded] + [p.grad.clone() for p in leaves]
    fill(1)
    eager = list(collectives()) + [p.grad.clone() for p in leaves]
    torch.cuda.synchronize()
    for i, (g, e) in enumerate(zip(got, eager)):
        assert g.dtype == e.dtype and torch.equal(g, e), i
    nccl = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "nccl" in e.name.lower()]
    assert nccl, "the replay launched no NCCL kernel"


CUTS = {"c4": C4_CUT, "c1": C1_CUT}


def cut_on(case, dev):
    """A cut on the card with its kernels (use_pallas) → (cfg, dataset, a
    plain Trainer of it)."""
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(**dict(CUTS[case], use_pallas=True))
    ds = RayDataset(*morton_rays(), device=dev)
    return cfg, ds, Trainer(cfg, ds, log=lambda s: None)


STEPS_B = 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c4", "c1"])
def test_cuda_one_wide_axes_step_captured(nccl_world, case):
    """The step body with explicit 1-wide axes on the NCCL world of one
    (module docstring, (b)): STEPS_B steps replayed from a graph of one
    step, and the same steps one at a time, from the same state and
    generator, end bitwise equal (parameters, loss, t cache, generator),
    with the kernels of the path counted once per replay (and once for the
    warm-up step). Then one step with the axes against one step without
    them, from the same state: config 1 (data axis only) bitwise, config 4
    (both axes) at the sharding tests' loss rtol 1e-5 and gradient rtol
    5e-3 / atol 1e-6."""
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
    from burn_raymarching_tpu_torch.ops.cuda import shade_kernel as k2
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer
    from burn_raymarching_tpu_torch.train.step_body import (
        lr_scale_tree,
        make_device_step,
    )

    dev = nccl_world
    ax_d, ax_m = one_wide_axes()
    cfg, ds, tr = cut_on(case, dev)
    if case == "c4":
        kw = dict(culled_march_fn=k3.culled_march_normals, warm=True,
                  march_normal_fn=None)
        axes = dict(data_axis=ax_d, model_axis=ax_m)
        counters = [k3.culled_march_normals]
        slots = 16
    else:
        kw = dict(march_normal_fn=k1.march_shade)
        axes = dict(data_axis=ax_d)
        counters = [k1.march_shade, k2.launch_shade_fwd, k2.launch_shade_bwd]
        slots = 8
    step_axes = make_device_step(cfg, batch=cfg.batch_size, repulsion_fn=None,
                                 **kw, **axes)
    step_none = make_device_step(cfg, batch=cfg.batch_size,
                                 repulsion_fn=None, **kw)
    t_start = torch.as_tensor(np.random.default_rng(2).uniform(
        1.0, 2.5, ds.num_total_pixels), dtype=torch.float32, device=dev)

    def start():
        padded, mask = pad_params(tr._init_params(), slots)
        return (padded, mask, make_optimizer(cfg, padded),
                tr._build_cluster_table(padded, mask),
                t_start.clone() if case == "c4" else None)

    runs = {}
    for graphs in (True, False):
        padded, mask, opt, clusters, t_cache = start()
        fg, n_fg = tr._sample_fg
        runner = ChunkRunner(
            step_axes, padded, opt, lr_scale_tree(cfg, 0), 0, mask,
            ds.packed, fg, n_fg,
            torch.Generator(device=dev).manual_seed(11), t_cache=t_cache,
            clusters=clusters, graphs=graphs)
        before = [fn.launches for fn in counters]
        runner.run(1, STEPS_B)
        torch.cuda.synchronize()
        launches = [fn.launches - b for fn, b in zip(counters, before)]
        assert launches == [STEPS_B + graphs] * len(counters), launches
        runs[graphs] = ([getattr(padded, k).detach().clone()
                         for k in PARAM_KEYS], float(runner.loss),
                        t_cache, runner.generator.get_state())
        runner.close()
    (p_g, l_g, t_g, g_g), (p_e, l_e, t_e, g_e) = runs[True], runs[False]
    for k, a, b in zip(PARAM_KEYS, p_g, p_e):
        assert torch.equal(a, b), k
    assert l_g == l_e and torch.equal(g_g, g_e)
    if case == "c4":
        assert torch.equal(t_g, t_e)

    # One step with and without the axes, from the same state.
    one = {}
    for name, step in (("axes", step_axes), ("none", step_none)):
        padded, mask, _, clusters, t_cache = start()
        fg, n_fg = tr._sample_fg
        loss, _ = step(padded, torch.Generator(device=dev).manual_seed(5), 0,
                       torch.tensor(1, device=dev), mask, ds.packed, fg,
                       n_fg, t_cache=t_cache, clusters=clusters)
        one[name] = (float(loss), [getattr(padded, k).grad.clone()
                                   for k in PARAM_KEYS])
    (l_a, g_a), (l_n, g_n) = one["axes"], one["none"]
    if case == "c1":
        assert l_a == l_n
        for k, a, b in zip(PARAM_KEYS, g_a, g_n):
            assert torch.equal(a, b), k
    else:
        np.testing.assert_allclose(l_a, l_n, rtol=1e-5)
        for k, a, b in zip(PARAM_KEYS, g_a, g_n):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=5e-3, atol=1e-6, err_msg=k)


def _summary(tr, padded, mask):
    return ({k: getattr(padded, k).detach().cpu().numpy()
             for k in PARAM_KEYS}, mask.cpu().numpy(),
            None if tr.t_cache is None else tr.t_cache.cpu().numpy(),
            list(tr.loss_history))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c4", "c1"])
def test_cuda_distributed_trainer_captured_matches_eager(nccl_world,
                                                         tmp_path,
                                                         monkeypatch, case):
    """The 1 x 1 DistributedTrainer over NCCL replays captured graphs (its
    "graphs" event) and ends bitwise where the same trainer ends when a
    subclass forces one step at a time: two stages with a density
    boundary, chunks of 4 steps."""
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )

    class Eager(DistributedTrainer):
        def _replays_graphs(self):
            return False

    monkeypatch.chdir(tmp_path)
    cfg, ds, _ = cut_on(case, nccl_world)
    runs = {}
    for cls in (DistributedTrainer, Eager):
        tr = cls(cfg, ds, data=1, model=1, log=lambda s: None)
        runs[cls] = (tr.events[0], _summary(tr, *tr.run()))
    (ev_g, (p_g, m_g, t_g, h_g)), (ev_e, (p_e, m_e, t_e, h_e)) = (
        runs[DistributedTrainer], runs[Eager])
    assert ev_g == dict(kind="graphs", graphs=True, backend="nccl",
                        mesh=[1, 1])
    assert ev_e["graphs"] is False
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(p_g[k], p_e[k], err_msg=k)
    np.testing.assert_array_equal(m_g, m_e)
    if case == "c4":
        np.testing.assert_array_equal(t_g, t_e)
    assert h_g == h_e


@pytest.mark.cuda
@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)])
def test_cuda_two_card_nccl_captured_matches_eager(tmp_path, data, model):
    """Two NCCL ranks, one per card: the config-4 cut through
    DistributedTrainer captured (collectives that move data recorded in
    the graph) against the same trainer one step at a time, bitwise on
    every rank; K3 launched (on the union table at 1 x 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one card per rank")
    res = torch_dist.run_ranks(
        tmp_path, 2, torch_dist.graphs_vs_eager, data, model,
        dict(C4_CUT, use_pallas=True), morton_rays(), str(tmp_path),
        backend="nccl")
    for r in res:
        g, e = r["graphs"], r["eager"]
        assert g["events"][0] == dict(kind="graphs", graphs=True,
                                      backend="nccl", mesh=[data, model])
        assert e["events"][0]["graphs"] is False
        for k in PARAM_KEYS:
            np.testing.assert_array_equal(g["params"][k], e["params"][k],
                                          err_msg=k)
        np.testing.assert_array_equal(g["t_cache"], e["t_cache"])
        assert g["loss_history"] == e["loss_history"]
        assert g["k3_launches"] > 0
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(res[0]["graphs"]["params"][k],
                                      res[1]["graphs"]["params"][k])


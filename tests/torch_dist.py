"""Multi-rank helpers for the port's sharding tests: spawn ``world``
processes that join one gloo process group (NCCL, one card per rank, for
the ``cuda`` tests that need two cards) through a FileStore under the
test's tmp_path (no TCP port, so parallel pytest workers never collide),
run one function per rank and hand its result back to the test. The
launcher is the dry-run tool's (tools/dryrun_multichip.spawn).

The rank functions live here, not in the test modules, so that a spawned
rank imports only torch and the port (never JAX). Every rank uses one
thread, every collective has a timeout, and every spawn a join timeout, so
a hung collective fails the test instead of stalling the suite.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

RANK_TIMEOUT_S = 120.0


def _rank_call(device, out, fn, args, kwargs):
    import torch.distributed as dist

    return fn(dist.get_rank(), dist.get_world_size(), *args, **kwargs)


def run_ranks(tmp_path, world: int, fn, *args,
              timeout: float = RANK_TIMEOUT_S, backend: str = "gloo",
              **kwargs) -> list:
    """``fn(rank, world, *args, **kwargs)`` on ``world`` ranks of
    ``backend`` (gloo, one CPU thread each; with "nccl" rank r takes card
    r) → the results in rank order, through the dry-run tool's launcher
    (tools/dryrun_multichip.spawn: a fresh FileStore directory under
    ``tmp_path`` for every call, so a store left by another world size in
    the same worker never hands the new ranks stale addresses; a rank that
    fails stops the others and its traceback is raised; ``timeout`` bounds
    every collective and the whole run)."""
    from burn_raymarching_tpu_torch.tools.dryrun_multichip import spawn

    return spawn(world, _rank_call, fn, args, kwargs,
                 device="cuda" if backend == "nccl" else "cpu",
                 backend=backend, timeout=timeout, root=str(tmp_path))


def nn(x):
    return x.detach().cpu().numpy()


# A tiny config-4 cut: tile culling, tile sampling, cluster repulsion
# (the sharded step's plain version with its prep computed in the step),
# warm start, decoupled decay; two stages with a density boundary.
C4_CUT = dict(batch_size=128, stages=2, steps_per_stage=8, steps_per_call=4,
              use_pallas=False, checkpoint_dir=None, use_culling=True,
              cull_tile=16, cull_budget=8, cluster_repulsion=True,
              cull_cluster_group=8, warm_start=True, warm_steps=4,
              sample_mode="tile", dataset_order="morton", init_n=12,
              init_layout="cloud", weight_decay_mode="decoupled")
# A tiny config-1 cut: the dense step (K1 + K2 on the card).
C1_CUT = dict(batch_size=1024, stages=2, steps_per_stage=8,
              steps_per_call=4, use_pallas=False, checkpoint_dir=None)


def morton_rays(size: int = 32):
    """The tests' 32 x 32 rig in Morton order: rays from [0, 0.5, -2.5],
    targets clip(|rd|, 0, 1)."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.utils.morton import (
        multi_view_morton_permutation,
    )

    ro, rd = create_camera_rays(size, size, [0.0, 0.5, -2.5], [0, 0, 0],
                                50.0, device="cpu")
    ro, rd = ro.numpy(), rd.numpy()
    perm = multi_view_morton_permutation(size, size, 1)
    return ro[perm], rd[perm], np.clip(np.abs(rd[perm]), 0, 1)


# --------------------------------------------------------------------------
# Rank functions. Ranks are laid out data-major: rank = d * model + m.


def _axes(data: int, model: int):
    from burn_raymarching_tpu_torch.parallel.mesh import make_mesh, mesh_axis

    mesh = make_mesh(data=data, model=model)
    return mesh, mesh_axis(mesh, "data"), mesh_axis(mesh, "model")


def _shard_rows(a: np.ndarray, axis) -> np.ndarray:
    n = a.shape[0] // axis.size
    return a[axis.index * n:(axis.index + 1) * n]


KEYS = ("centers", "colors", "radii", "light_dir", "ambient")
ROWS = KEYS[:3]


class Leaves:
    """The five raw leaves with SceneParams' attribute names, in any float
    dtype (SceneParams holds float32)."""

    def __init__(self, **leaves):
        self.__dict__.update(leaves)

    def parameters(self):
        return [getattr(self, k) for k in KEYS]


def sharded_functions(rank, world, data, model, inp, dtype_name):
    """The model-axis functions on this rank's shard → dict of numpy
    arrays: values (replicated ones from every rank) and gradients (of this
    rank's rows, and of the replicated leaves).

    ``inp``: raw params (centers, colors, radii, light_dir, ambient), mask,
    ro/rd/tgt (the whole batch; data rank d takes block d), cot (output
    cotangent), k, the culled render's tile and per-shard budget, and the
    cluster group of the repulsion."""
    from burn_raymarching_tpu_torch.models.scene import (
        activate,
        scene_forward,
    )
    from burn_raymarching_tpu_torch.ops.culling import PrimitiveClusters
    from burn_raymarching_tpu_torch.parallel.collectives import mean_grads
    from burn_raymarching_tpu_torch.render.culled import render_diff_culled
    from burn_raymarching_tpu_torch.train.loss import (
        cluster_repulsion,
        compute_loss,
    )

    dt = getattr(torch, dtype_name)
    _, dax, max_ = _axes(data, model)
    ma = max_ if model > 1 else None

    def t(x, **kw):
        return torch.as_tensor(np.asarray(x), **kw)

    def fresh():
        """This rank's leaves (SceneParams' attributes and parameters(),
        in ``dt``: float64 runs the same code as the yardstick)."""
        return Leaves(**{k: t(_shard_rows(inp[k], max_) if k in ROWS
                              else inp[k], dtype=dt).requires_grad_()
                         for k in KEYS})

    mask = t(_shard_rows(inp["mask"], max_))
    ro, rd, tgt, cot = (t(_shard_rows(inp[k], dax), dtype=dt)
                        for k in ("ro", "rd", "tgt", "cot"))
    k = inp["k"]
    out = {}

    def grads(p, name):
        for key in ("centers", "colors", "radii", "light_dir", "ambient"):
            g = getattr(p, key).grad
            out[f"{name}_grad_{key}"] = (np.zeros(getattr(p, key).shape)
                                         if g is None else nn(g))

    # Dense render: forward, then the gradient of mean(out * cot) over the
    # rays, averaged over the data axis like the training step's (equal
    # shards: the mean of shard means is the batch mean).
    p = fresh()
    img = scene_forward(p, ro, rd, k, mask=mask, model_axis=ma)
    out["render"] = nn(img)
    ((img * cot).sum() / ro.shape[0]).backward()
    if data > 1:
        mean_grads(p.parameters(), dax, extra=torch.zeros((), dtype=dt))
    grads(p, "render")

    # The loss on a fixed output: value and gradients.
    p = fresh()
    loss = compute_loss(p, t(inp["loss_out"], dtype=dt),
                        t(inp["loss_tgt"], dtype=dt), 0.4, mask=mask,
                        model_axis=ma)
    loss.backward()
    out["loss"] = float(loss.detach())
    grads(p, "loss")

    # The full training objective (render → loss), data-averaged.
    p = fresh()
    img = scene_forward(p, ro, rd, k, mask=mask, model_axis=ma)
    loss = compute_loss(p, img, tgt, 0.5, mask=mask, model_axis=ma)
    loss.backward()
    loss = loss.detach()
    if data > 1:
        loss = mean_grads(p.parameters(), dax, extra=loss)
    out["step_loss"] = float(loss)
    grads(p, "step")

    # Culled render: each shard selects its own per-tile top-K.
    p = fresh()
    c, col, r, ld, amb = activate(p)
    img = render_diff_culled(ro, rd, c, col, r, ld, amb, k, mask=mask,
                             tile=inp["tile"], k_budget=inp["k_budget"],
                             model_axis=ma)
    out["culled"] = nn(img)
    ((img * cot).sum() / ro.shape[0]).backward()
    if data > 1:
        mean_grads(p.parameters(), dax, extra=torch.zeros((), dtype=dt))
    grads(p, "culled")

    # Cluster repulsion over consecutive G-groups of the shard's rows.
    g = inp["group"]
    m_local = mask.shape[0]
    clusters = PrimitiveClusters(torch.arange(m_local).reshape(-1, g),
                                 torch.ones((m_local // g, g), dtype=bool))
    for far in ("member", "monopole"):
        c = t(_shard_rows(inp["centers"], max_), dtype=dt).requires_grad_()
        v = cluster_repulsion(c, clusters, mask, float(inp["mask"].sum()),
                              near_clusters=2, far_field=far, model_axis=ma)
        v.backward()
        out[f"rep_{far}"] = float(v.detach())
        out[f"rep_{far}_grad"] = nn(c.grad)
    return out


def union_march(rank, world, model, inp, t_init):
    """The per-shard culled march two ways on the same shard tables: the
    union-table march through the K3 wrapper (its plain version on the CPU)
    and the plain march that combines shards at every step."""
    from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
        culled_march_normals,
    )
    from burn_raymarching_tpu_torch.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.train.step_body import (
        sharded_culled_kernel_march,
    )

    _, _, ax = _axes(1, model)
    c = torch.as_tensor(_shard_rows(inp["centers"], ax))
    r = torch.as_tensor(_shard_rows(inp["radii_phys"], ax))
    mask = torch.as_tensor(_shard_rows(inp["mask"], ax))
    ro, rd = torch.as_tensor(inp["ro"]), torch.as_tensor(inp["rd"])
    tile, k = inp["tile"], inp["k"]
    idx, valid = select_tile_primitives(tile_cones(ro, rd, tile), c, r, k,
                                        inp["k_budget"], mask=mask)
    cs = c[idx]
    rs = r.reshape(-1)[idx]
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    b = ro.shape[0] // tile
    ro3, rd3 = ro.reshape(b, tile, 3), rd.reshape(b, tile, 3)
    t0 = None if t_init is None else torch.as_tensor(t_init)
    steps = 40 if t_init is None else 16
    t_x, n_x = culled_march_normals_xla(ro3, rd3, cs, rs, qs, k,
                                        num_steps=steps, t_init=t0,
                                        model_axis=ax)
    t_u, n_u = sharded_culled_kernel_march(
        culled_march_normals, ax, ro3, rd3, cs, rs, qs, k,
        num_steps=steps, normal_eps=1e-4, t_init=t0)
    return {"t_plain": nn(t_x), "n_plain": nn(n_x), "t_union": nn(t_u),
            "n_union": nn(n_u)}


def _run_summary(tr, padded, mask) -> dict:
    return {"params": {k: nn(getattr(padded, k)) for k in KEYS},
            "mask": nn(mask),
            "t_cache": None if tr.t_cache is None else nn(tr.t_cache),
            "loss_history": list(tr.loss_history), "events": tr.events,
            "warm": tr.warm, "io": tr._io}


def train_distributed(rank, world, data, model, cfg_kw, dataset_arrays,
                      out_dir, single=False, kernel_wrappers=False,
                      probe_batch=None):
    """DistributedTrainer.run on a (data, model) mesh, in ``out_dir`` →
    the whole final table (every rank holds it), this rank's t-cache
    shard, the loss history and the trainer's events; with ``single`` also
    the single-device Trainer's run of the same configuration. With
    ``kernel_wrappers`` the step and the prefill take the K3 wrapper (its
    plain version on the CPU), so that the trainer's culled marches go
    through the union table. With ``probe_batch`` the result also holds the
    error (or None) of a DistributedTrainer built with that batch size."""
    from burn_raymarching_tpu_torch.config import DensityConfig, TrainConfig
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
        culled_march_normals,
    )
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )
    from burn_raymarching_tpu_torch.train.loop import Trainer

    # Every rank in a directory of its own: only rank 0's trainer writes,
    # but the single-device trainer writes on every rank.
    os.makedirs(os.path.join(out_dir, f"rank{rank}"), exist_ok=True)
    os.chdir(os.path.join(out_dir, f"rank{rank}"))
    cfg_kw = dict(cfg_kw)
    if "density" in cfg_kw:
        cfg_kw["density"] = DensityConfig(**cfg_kw["density"])
    cfg = TrainConfig(**cfg_kw)
    ds = RayDataset(*dataset_arrays, device="cpu")
    tr = DistributedTrainer(cfg, ds, data=data, model=model,
                            log=lambda s: None)
    if kernel_wrappers:
        tr.culled_march_normal_fn = culled_march_normals
        tr.step_fn = tr._build_step()
    out = _run_summary(tr, *tr.run())
    if probe_batch is not None:
        out["probe_error"] = None
        try:
            DistributedTrainer(
                dataclasses.replace(cfg, batch_size=probe_batch), ds,
                data=data, model=model, log=lambda s: None)
        except ValueError as e:
            out["probe_error"] = str(e)
    if single:
        one = Trainer(cfg, ds, log=lambda s: None)
        out["single"] = _run_summary(one, *one.run())
    return out


def collective_grads(rank, world):
    """psum / pvary / all_gather on 2 ranks: y = sum_r (x_r * pvary(w)),
    z = sum(all_gather(x)) * w → gradients of y + z."""
    import torch.distributed as dist

    from burn_raymarching_tpu_torch.parallel.collectives import (
        Axis,
        all_gather,
        psum,
        pvary,
    )

    ax = Axis(group=dist.group.WORLD, size=world, index=rank)
    x = torch.tensor([1.0 + rank, 2.0 + rank], requires_grad=True)
    w = torch.tensor(3.0, requires_grad=True)
    y = psum(torch.sum(x * pvary(w, ax)), ax)
    z = torch.sum(all_gather(x, ax)) * w
    (y + z).backward()
    return {"x_grad": x.grad.numpy(), "w_grad": float(w.grad),
            "value": float(y + z)}


def union_march_cuda(rank, world, inp, t_init):
    """The union-table march on the card (2 gloo ranks share it): through
    K3, through the plain version on the same union tables, and the plain
    version in float64 → numpy, with K3's launches on this rank."""
    from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
        culled_march_normals,
    )
    from burn_raymarching_tpu_torch.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.train.step_body import (
        sharded_culled_kernel_march,
    )

    dev = torch.device("cuda", 0)
    _, _, ax = _axes(1, world)

    def t(key):
        return torch.as_tensor(_shard_rows(inp[key], ax), device=dev)

    c, r, mask = t("centers"), t("radii_phys"), t("mask")
    ro = torch.as_tensor(inp["ro"], device=dev)
    rd = torch.as_tensor(inp["rd"], device=dev)
    tile, k = inp["tile"], inp["k"]
    idx, valid = select_tile_primitives(tile_cones(ro, rd, tile), c, r, k,
                                        inp["k_budget"], mask=mask)
    cs = c[idx]
    rs = r.reshape(-1)[idx]
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    b = ro.shape[0] // tile
    args = (ro.reshape(b, tile, 3), rd.reshape(b, tile, 3), cs, rs, qs)
    t0 = None if t_init is None else torch.as_tensor(t_init, device=dev)
    kw = dict(num_steps=40 if t_init is None else 16, normal_eps=1e-4)
    before = culled_march_normals.launches
    t_k, n_k = sharded_culled_kernel_march(culled_march_normals, ax, *args,
                                           k, t_init=t0, **kw)
    torch.cuda.synchronize()
    launches = culled_march_normals.launches - before
    t_p, n_p = sharded_culled_kernel_march(culled_march_normals_xla, ax,
                                           *args, k, t_init=t0, **kw)
    t_64, n_64 = sharded_culled_kernel_march(
        culled_march_normals_xla, ax, *(a.double() for a in args), k,
        t_init=None if t0 is None else t0.double(), **kw)
    return {"t_k": nn(t_k), "n_k": nn(n_k), "t_p": nn(t_p), "n_p": nn(n_p),
            "t_64": nn(t_64), "n_64": nn(n_64), "launches": launches}


def _stage_setup(tr, cfg):
    """What Trainer.run_stage sets up for stage 0 of ``tr``: (padded params
    on this rank, mask, optimizer, cluster table, sampling pools)."""
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.train.optimizer import (
        anneal_for_step,
        make_optimizer,
    )

    params = tr._prepare_stage_params(tr._init_params())
    padded, mask = tr._place(*pad_params(params, tr._bucket(params.n)))
    if tr.warm:
        tr.prefill_t_cache(padded, mask, anneal_for_step(cfg, 0, 1)[1])
    return (padded, mask, make_optimizer(cfg, padded),
            tr._build_cluster_table(padded, mask), *tr._sample_fg)


def sharded_chunk_vs_steps(rank, world, data, model, cfg_kw, dataset_arrays,
                           steps):
    """parallel/train_step.make_sharded_chunk_runner's runner for ``steps``
    steps of stage 0, and ``steps`` calls of make_sharded_train_step (each
    followed by the learning rates and Adam, as the runner's step does),
    both from the stage start of the same DistributedTrainer and a
    generator of the same seed → numpy of both: parameters, last loss,
    t cache, generator state, and whether the runner replays graphs."""
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
        culled_march_normals,
    )
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )
    from burn_raymarching_tpu_torch.parallel.train_step import (
        make_sharded_chunk_runner,
        make_sharded_train_step,
    )
    from burn_raymarching_tpu_torch.train.optimizer import set_group_lrs
    from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree

    cfg = TrainConfig(**cfg_kw)
    tr = DistributedTrainer(cfg, RayDataset(*dataset_arrays, device="cpu"),
                            data=data, model=model, log=lambda s: None)
    kernels = dict(culled_march_fn=culled_march_normals, warm=tr.warm)
    scales = lr_scale_tree(cfg, 0)
    out = {}
    for mode in ("runner", "steps"):
        # The stage start refills the whole t cache (prefill_t_cache).
        padded, mask, opt, clusters, fg, n_fg = _stage_setup(tr, cfg)
        gen = tr._stage_generator(np.asarray([0, 7], np.uint32))
        if mode == "runner":
            runner = make_sharded_chunk_runner(
                cfg, tr.mesh, graphs=tr._replays_graphs(), **kernels)(
                padded, opt, scales, 0, mask, tr.dataset.packed, fg, n_fg,
                gen, t_cache=tr.t_cache, clusters=clusters)
            runner.run(1, steps)
            loss, graphs = runner.loss, runner.graphs
        else:
            step = make_sharded_train_step(cfg, tr.mesh, **kernels)
            for s in range(1, steps + 1):
                loss, lr = step(padded, gen, 0, torch.tensor(s), mask,
                                tr.dataset.packed, fg, n_fg,
                                t_cache=tr.t_cache, clusters=clusters)
                set_group_lrs(opt, lr, scales)
                opt.step()
            graphs = None
        out[mode] = {"params": {k: nn(getattr(padded, k)) for k in KEYS},
                     "loss": float(loss), "graphs": graphs,
                     "t_cache": (None if tr.t_cache is None
                                 else nn(tr.t_cache)),
                     "generator": nn(gen.get_state())}
    return out


def graphs_vs_eager(rank, world, data, model, cfg_kw, dataset_arrays,
                    out_dir):
    """DistributedTrainer.run on this rank's card, replaying captured
    graphs over NCCL (over gloo: on the CPU, one step at a time), then the
    same trainer forced to one step at a time (a subclass's
    ``_replays_graphs``) → both runs' summaries and K3's launches in the
    first run."""
    import torch.distributed as dist

    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )

    class Eager(DistributedTrainer):
        def _replays_graphs(self):
            return False

    os.makedirs(os.path.join(out_dir, f"rank{rank}"), exist_ok=True)
    os.chdir(os.path.join(out_dir, f"rank{rank}"))
    cfg = TrainConfig(**cfg_kw)
    dev = (torch.device("cuda", rank) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    ds = RayDataset(*dataset_arrays, device=dev)
    out = {}
    for mode, cls in (("graphs", DistributedTrainer), ("eager", Eager)):
        k3.culled_march_normals.launches = 0
        tr = cls(cfg, ds, data=data, model=model, log=lambda s: None)
        out[mode] = _run_summary(tr, *tr.run())
        out[mode]["k3_launches"] = k3.culled_march_normals.launches
    return out


def sharded_chunks_with_draws(rank, world, data, model, cfg_kw,
                              dataset_arrays, raw, slots, t_init, draws,
                              stage, chunk):
    """make_sharded_chunk_runner's runner (one step at a time, gloo) over
    ``len(draws)`` steps of ``stage`` in chunks of ``chunk``, from the
    whole padded table ``raw`` ({key: live rows}, padded to ``slots``) and
    the whole t cache ``t_init``, with the batch draws injected:
    ``draws[s][d]`` are data rank d's ids at step s + 1 (tile ids with
    tile sampling, else pixel ids; shard-local) → the loss at each chunk
    end and the schedule the step computed at each step ([step, progress,
    smooth_k, uniform_ratio, lr])."""
    import burn_raymarching_tpu_torch.train.step_body as sb
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        params_from_numpy,
    )
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )
    from burn_raymarching_tpu_torch.parallel.train_step import (
        make_sharded_chunk_runner,
    )
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer

    cfg = TrainConfig(**cfg_kw)
    tr = DistributedTrainer(cfg, RayDataset(*dataset_arrays, device="cpu"),
                            data=data, model=model, log=lambda s: None)
    padded, mask = tr._place(*pad_params(params_from_numpy(raw, device="cpu"),
                                         slots))
    if tr.warm:
        lo = tr.data_axis.index * tr.dataset.p_local
        tr.t_cache.copy_(torch.as_tensor(t_init[lo:lo + tr.dataset.p_local]))
    tile = cfg.cull_tile if cfg.sample_mode == "tile" else 1

    def idx_fn(step):
        ids = torch.as_tensor(draws[step - 1][tr.data_axis.index]).long()
        return (ids[:, None] * tile + torch.arange(tile)).reshape(-1)

    seen = []
    schedule = sb.device_schedule

    def recording(cfg_, stage_, step):
        out = schedule(cfg_, stage_, step)
        seen.append([int(step)] + [float(x) for x in out])
        return out

    sb.device_schedule = recording
    fg, n_fg = tr._sample_fg
    runner = make_sharded_chunk_runner(
        cfg, tr.mesh, graphs=tr._replays_graphs(), warm=tr.warm)(
            padded, make_optimizer(cfg, padded),
            sb.lr_scale_tree(cfg, stage), stage, mask, tr.dataset.packed,
            fg, n_fg, torch.Generator().manual_seed(0), t_cache=tr.t_cache,
            clusters=tr._build_cluster_table(padded, mask), idx_fn=idx_fn)
    losses = []
    for start in range(0, len(draws), chunk):
        runner.run(start + 1, chunk)
        losses.append(float(runner.loss))
    return {"losses": losses, "schedule": seen}


def dp_checked_run(rank, world, cfg_kw, dataset_arrays, out_dir, n_steps):
    """DistributedTrainer at world x 1 as the benchmark's data-parallel
    cell drives it (benchmark/harness/train.py's ``check_steps`` and
    ``BoundaryProbe``): the first ``n_steps`` steps of a run one at a
    time, then the run again through its first stage boundary and the
    next stage's first ``n_steps`` steps → what both kept (each step's
    loss, this rank's draws, the stage-start parameters, the gradient as
    Adam holds it after the first step, the parameters after the last;
    density control's input and answer), on the host."""
    from benchmark.harness.train import BoundaryProbe, _on_cpu, check_steps
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )
    from burn_raymarching_tpu_torch.train import loop, step_body

    os.makedirs(os.path.join(out_dir, f"rank{rank}"), exist_ok=True)
    os.chdir(os.path.join(out_dir, f"rank{rank}"))
    cfg = TrainConfig(**cfg_kw)
    tr = DistributedTrainer(cfg, RayDataset(*dataset_arrays, device="cpu"),
                            data=world, model=1, log=lambda s: None)
    got = check_steps(tr, loop, step_body, n_steps)

    class Stop(Exception):
        pass

    probe = BoundaryProbe(n_steps)
    probe.wrap(tr)
    base = loop.ChunkRunner

    class Runner(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.probed = probe.starts(self)

        def run(self, first, n):
            if self.probed:
                probe.record(super().run, self, first, n)
                raise Stop
            super().run(first, n)

    loop.ChunkRunner = Runner
    try:
        tr.run()
    except Stop:
        pass
    finally:
        loop.ChunkRunner = base
    return {"got": got, "boundary": _on_cpu(probe.got), "seed": probe.seed}


def run_c5_mesh(rank, world, cfg_kw, dataset_arrays):
    """tools/run_c5's mesh on a world of ranks: the trainer it builds for
    ``--distributed`` with the default mesh and with ``--mesh`` given, and
    the message of each mesh it refuses."""
    import argparse

    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.tools import run_c5

    cfg = TrainConfig(**cfg_kw)
    ds = RayDataset(*dataset_arrays, device="cpu")
    out = {"meshes": {}, "refused": {}}
    for text in (None, f"{world}x1"):
        args = argparse.Namespace(distributed=True, mesh=text)
        (ran,) = [e for e in run_c5.make_trainer(args, cfg, ds).events
                  if e["kind"] == "graphs"]
        out["meshes"][str(text)] = ran["mesh"]
    for text in (f"{2 * world}x1", "1x1", f"1x{world + 1}", "four"):
        try:
            run_c5.world_mesh(text, world)
        except SystemExit as e:
            out["refused"][text] = str(e)
    return out

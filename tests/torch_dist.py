"""Multi-rank helpers for the port's sharding tests: spawn ``world``
processes that join one gloo process group through a FileStore under the
test's tmp_path (no TCP port, so parallel pytest workers never collide),
run one function per rank and hand its result back to the test.

The rank functions live here, not in the test modules, so that a spawned
rank imports only torch and the port (never JAX). Every rank uses one
thread, every collective has a timeout, and every spawn a join timeout, so
a hung collective fails the test instead of stalling the suite.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import traceback

import numpy as np
import torch

RANK_TIMEOUT_S = 120.0


def _rank_main(rank: int, world: int, store: str, out_dir: str, fn, args,
               kwargs):
    torch.set_num_threads(1)
    import torch.distributed as dist

    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        result = fn(rank, world, *args, **kwargs)
        dist.barrier()
        dist.destroy_process_group()
        with open(path, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:                                   # noqa: BLE001
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(tmp_path, world: int, fn, *args,
              timeout: float = RANK_TIMEOUT_S, **kwargs) -> list:
    """``fn(rank, world, *args, **kwargs)`` on ``world`` gloo ranks → the
    results in rank order; raises with the first failing rank's
    traceback."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path / f"ranks_{fn.__name__}_{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, out_dir, fn, args, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} wrote no result (hung: {hung}, "
                               f"exit codes "
                               f"{[p.exitcode for p in procs]})")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        results.append(value)
    return results


def nn(x):
    return x.detach().cpu().numpy()


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
    ds = RayDataset(*dataset_arrays)
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

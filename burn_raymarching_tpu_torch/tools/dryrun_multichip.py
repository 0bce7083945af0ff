"""The entry forward and the multi-card dry run (port of the repository's
__graft_entry__.py).

``entry(device)`` → (fn, args): the flagship forward of
__graft_entry__.entry(), ``models/scene.scene_forward`` with the plain
march on a 100-sphere init padded to 128 slots, over a 128 x 128 camera
from (0, 0.5, -2.5) at fov 50 (16,384 rays), smooth_k 32.

``dryrun_multichip(n)`` runs, on every rank of an n-rank (data, model)
mesh, the five parts of __graft_entry__.dryrun_multichip in its order and
with its configurations and shapes:

  (a) dense  — one sharded training step (parallel/train_step.
               make_sharded_train_step: sample, the plain march and shade,
               the loss, gradients averaged over the data axis, Adam) on
               the 16 x 16 rig, 7 spheres in 8 slots, targets
               clip(|sin(i)|, 0, 1), batch 16 per data rank;
  (b) culled — the same step with per-tile culling (tile 8, budget 4 per
               model shard);
  (c) driver — the whole DistributedTrainer: 2 stages x 2 steps on the
               32 x 32 rig with warm start, hierarchical culling, cluster
               repulsion, tile sampling and density control between the
               stages; its parameters finite, its t cache written;
  (d) kernel — a DistributedTrainer at data = n, model = 1 whose culled
               march is K3 (ops/cuda/culled_march_kernel.py), set after
               construction with the step rebuilt, as the JAX dry run
               sets its Pallas kernel;
  (e) union  — at model 2, (c)'s configuration with K3 on the union table
               (train/step_body.sharded_culled_kernel_march).

The mesh follows the JAX rule: model 2 when n is even, else 1; data =
n // model. Every step runs as the trainer runs it (train/chunk.
ChunkRunner): a replay of a captured CUDA graph when every mesh axis is
NCCL on the card, one step at a time over gloo (parallel/train_step.
replays_graphs). The JAX step takes its anneals and a PRNG key as
arguments; the port's step computes the anneals from (stage, step) on the
device and samples with a torch.Generator, so parts (a) and (b) run step
1 of stage 0 with generators seeded from keys (0, 0) and (0, 1) (the JAX
keys 0 and 1), folded with the data index on a data axis wider than one.
A part raises if its parameters are not finite, and (d) and (e) raise
unless K3 ran: on the card its launch count must grow, on the CPU (where
the wrapper runs its plain version) the calls into it. ``parts`` runs a
subset, in the same order: over gloo ranks that share a card, part (c)'s
plain march at model 2 stages some 6,000 all-reduces through host memory,
so a quick check of K3 on the union table there runs (d) and (e) alone.

The summary is one JSON line: the mesh, loss, culled_loss, driver_n (the
live spheres after (c)), the kernel and union flags, and per part its
wall seconds (the slowest rank's), ``graphs``, the kernel launches summed
over the ranks (every counted wrapper, ops/cuda/build.COUNTED; a replay
counts its kernels once), ``k3_launches`` and ``k3_calls`` (calls into
K3's wrapper from Python; a captured graph's replays make none).

``--width c4`` runs parts (c)-(e) at full width instead: config 4's recipe
(tools/run_c5.py's flags of runs/c4_r2: 30 views at 512², 5,120 spheres
seeded from the knot prior in 8,192 slots, per-tile budget 2,048, tile
sampling, warm start, cluster repulsion), its knot set written by the
port's generator unless ``--data`` names one, the global batch of 16,384,
cut to 1 stage x 60 steps, on the meshes n x 1 (K3 directly) and, for even
n, (n/2) x 2 (K3 on the union table). After the run, 20 steady steps of
the same step from the trained state are timed on every rank: wall and
device-busy ms a step, host launch calls a step, K3's and the NCCL
kernels' device ms a step (tools/device_time.profile_calls) and peak
memory; and the mesh's rays/s. It needs the card.

Ranks: ``main`` spawns the n ranks itself (spawn context, a FileStore in a
fresh temporary directory for every world, a join timeout; a rank that
fails stops the others and its traceback is raised), or runs in the world
it finds under ``torch.distributed.run``. NCCL takes one card per rank and
refuses two ranks on one card: with fewer cards than ranks the run stops
with both numbers and exits nonzero, and nothing falls back to gloo or to
the CPU. ``--backend gloo`` is the caller's choice: its ranks share the
cards (rank r on card r mod cards) or run on the CPU, and their steps run
one at a time.

Usage:
  python -m burn_raymarching_tpu_torch.tools.dryrun_multichip --entry
  python -m burn_raymarching_tpu_torch.tools.dryrun_multichip --n 2
      [--device cuda|cpu] [--backend nccl|gloo]
  python -m burn_raymarching_tpu_torch.tools.dryrun_multichip --n 4
      --width c4 [--data KNOT_SET_DIR]
  python -m torch.distributed.run --nproc-per-node 4 \\
      -m burn_raymarching_tpu_torch.tools.dryrun_multichip --n 4
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.data.dataset import RayDataset
from burn_raymarching_tpu_torch.models.scene import (
    init_scene_params,
    pad_params,
    scene_forward,
    unpad_params,
)
from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
    culled_march_normals,
)
from burn_raymarching_tpu_torch.parallel.distributed import (
    DistributedTrainer,
)
from burn_raymarching_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    mesh_axis,
)
from burn_raymarching_tpu_torch.parallel.train_step import (
    make_sharded_chunk_runner,
    replays_graphs,
    shard_params,
)
from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
from burn_raymarching_tpu_torch.train.loop import (
    build_dataset,
    fold_key,
    generator_from_key,
)
from burn_raymarching_tpu_torch.train.optimizer import make_optimizer
from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree
from burn_raymarching_tpu_torch.utils.device import resolve_device

# The rig of every camera here (__graft_entry__.py:32, :73, :109).
EYE, TARGET, FOV = [0.0, 0.5, -2.5], [0.0, 0.0, 0.0], 50.0
# The entry forward (__graft_entry__.py:30-34).
ENTRY_LIVE, ENTRY_SLOTS, ENTRY_SIZE, ENTRY_K = 100, 128, 128, 32.0
# Parts (c) and (e) (__graft_entry__.py:113-120), batch 32 per data rank,
# and part (d) (:136-142), batch 32 per rank of the world.
CFG_FULL = dict(stages=2, steps_per_stage=2, steps_per_call=2,
                use_pallas=False, checkpoint_dir=None, use_culling=True,
                cull_tile=16, cull_budget=8, cull_hierarchical=True,
                cull_cluster_group=8, cull_cluster_budget=2,
                cluster_repulsion=True, warm_start=True, warm_steps=4,
                sample_mode="tile", dataset_order="morton", init_n=12,
                init_layout="cloud", weight_decay_mode="decoupled")
CFG_K = dict(stages=1, steps_per_stage=2, steps_per_call=2, use_pallas=False,
             checkpoint_dir=None, use_culling=True, cull_tile=16,
             cull_budget=8, warm_start=True, warm_steps=4, sample_mode="tile",
             dataset_order="morton", init_n=12, init_layout="cloud",
             weight_decay_mode="decoupled")
# Config 4 (runs/c4_r2) as tools/run_c5.py flags, the global batch its
# default 16,384, cut to 1 stage x C4_STEPS steps; then STEADY_STEPS timed.
C4_RECIPE = ("--views", "30", "--size", "512", "--gt-n", "400", "--init-n",
             "5120", "--cull-budget", "2048", "--merge-cell", "0.04")
C4_STEPS, WARMUP_STEPS, STEADY_STEPS = 60, 5, 20
# Seconds a collective may wait, and seconds all ranks may take.
COLLECTIVE_TIMEOUT_S, JOIN_TIMEOUT_S = 600.0, 1800.0
PARTS = ("dense", "culled", "driver", "kernel", "union")


def mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) of an n-rank dry run (__graft_entry__.py:59-61): the
    model axis is 2 when it divides n evenly."""
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return n // model, model


def c4_meshes(n: int) -> list[tuple[int, int]]:
    """The full-width meshes of n ranks: n x 1, and (n/2) x 2 for even n."""
    return [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else [])


def check_backend(n: int, device: str, backend: Optional[str]) -> str:
    """The backend of an n-rank run on ``device`` (NCCL on the card, gloo
    on the CPU, unless ``backend`` says otherwise). NCCL takes one card
    per rank: with fewer cards than ranks this raises and names both."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise RuntimeError("NCCL runs between cards; --device cpu "
                               "takes --backend gloo")
        cards = torch.cuda.device_count()
        if cards < n:
            raise RuntimeError(
                f"NCCL takes one card per rank: the run needs {n} cards, "
                f"this machine has {cards} (--backend gloo shares them)")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card LOCAL_RANK (else ``rank``)
    mod cards, its own card under NCCL and a shared one under gloo when
    there are fewer cards than ranks."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


# --------------------------------------------------------------------------
# The entry forward.


def entry(device="cuda", size: int = ENTRY_SIZE) -> tuple[Callable, tuple]:
    """(fn, args) of the flagship forward (__graft_entry__.entry):
    ``fn(params, ro, rd, smooth_k, mask)`` is scene_forward with the plain
    march; args are init_scene_params(100) padded to 128 slots, the rays
    of a ``size`` x ``size`` camera (16,384 at the default 128), smooth_k
    32 and the slot mask, on ``device``."""
    dev = resolve_device(device)
    padded, mask = pad_params(init_scene_params(ENTRY_LIVE, device=dev),
                              ENTRY_SLOTS)
    ro, rd = create_camera_rays(size, size, EYE, TARGET, FOV, device=dev)

    def fn(params, ro, rd, smooth_k, mask):
        return scene_forward(params, ro, rd, smooth_k, mask=mask)

    return fn, (padded, ro, rd, ENTRY_K, mask)


# --------------------------------------------------------------------------
# Parts (a) and (b): one sharded step on the tiny rig.


def tiny_inputs(device) -> tuple:
    """__graft_entry__.py:68-78 → (padded params, mask, packed [256, 9]
    rays and targets, fg pool, n_fg): 7 spheres in 8 slots, the 16 x 16
    rig, targets clip(|sin(i)|, 0, 1) over its 256 x 3 values, every pixel
    in the fg pool with 128 of them counted."""
    padded, mask = pad_params(init_scene_params(7, device=device), 8)
    ro, rd = create_camera_rays(16, 16, EYE, TARGET, FOV, device=device)
    tgt = torch.clip(torch.abs(torch.sin(torch.arange(
        256 * 3, dtype=torch.float32, device=device))).reshape(256, 3), 0, 1)
    fg = torch.arange(256, dtype=torch.int32, device=device)
    return padded, mask, torch.cat([ro, rd, tgt], dim=1), fg, 128


def tiny_config(data: int, culled: bool) -> TrainConfig:
    """The TrainConfig of part (a), or of part (b) with ``culled``
    (__graft_entry__.py:64, :92-93)."""
    if culled:
        return TrainConfig(batch_size=16 * data, use_culling=True,
                           cull_tile=8, cull_budget=4)
    return TrainConfig(batch_size=16 * data)


def tiny_step(mesh, culled: bool, seed: int, device,
              draws: Optional[list] = None) -> tuple[float, bool]:
    """Step 1 of stage 0 of the sharded step on the tiny inputs (this
    rank's rows on a model axis), run as ChunkRunner runs it, then Adam →
    (loss, whether it replayed a captured graph). ``draws[d]`` injects
    data rank d's batch indices (tests)."""
    data, model = mesh_axis(mesh, "data"), mesh_axis(mesh, "model")
    cfg = tiny_config(data.size, culled)
    padded, mask, packed, fg, n_fg = tiny_inputs(device)
    if model.size > 1:
        padded, mask = shard_params(padded, mask, mesh)
    key = np.asarray([0, seed], np.uint32)
    if data.size > 1:
        key = fold_key(key, data.index)
    idx_fn = None
    if draws is not None:
        ids = torch.as_tensor(np.asarray(draws[data.index]), device=device)
        idx_fn = lambda step: ids.long()                      # noqa: E731
    graphs = replays_graphs(device, (data, model))
    runner = make_sharded_chunk_runner(cfg, mesh, graphs=graphs)(
        padded, make_optimizer(cfg, padded), lr_scale_tree(cfg), 0, mask,
        packed, fg, n_fg, generator_from_key(key, device), idx_fn=idx_fn)
    runner.run(1, 1)
    loss = float(runner.loss)
    _require_finite(runner.params, loss, "dense" if not culled else "culled")
    runner.close()
    return loss, graphs


def tiny_losses(device, out: str, data: int, model: int, draws: list
                ) -> dict:
    """A rank function (``spawn``): parts (a) and (b) on a (data, model)
    mesh with ``draws`` injected → {"dense": loss, "culled": loss}."""
    mesh = make_mesh(data=data, model=model)
    return {"dense": tiny_step(mesh, False, 0, device, draws)[0],
            "culled": tiny_step(mesh, True, 1, device, draws)[0]}


# --------------------------------------------------------------------------
# The dry run on one rank.


class CountedK3:
    """K3's wrapper, counting the calls made into it: on the CPU each runs
    the plain version, so its launch count cannot show that it ran."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return culled_march_normals(*args, **kwargs)


def _require_finite(params, loss: Optional[float], part: str) -> None:
    if loss is not None and not np.isfinite(loss):
        raise FloatingPointError(f"{part}: non-finite loss {loss}")
    for p in params.parameters():
        if not bool(torch.isfinite(p).all()):
            raise FloatingPointError(f"{part}: non-finite parameters")


def _require_k3(device, launches: int, k3: CountedK3, part: str) -> None:
    """K3 ran in ``part``: on the card its launches grew, on the CPU its
    wrapper was called (a count of 0 means the plain march ran)."""
    ran = launches if device.type == "cuda" else k3.calls
    if ran <= 0:
        raise RuntimeError(f"{part}: K3 never ran (launches {launches}, "
                           f"calls {k3.calls})")


def _with_k3(trainer: DistributedTrainer) -> CountedK3:
    """Swap the trainer's culled march for K3 after construction and
    rebuild its step (__graft_entry__.py:145-147)."""
    k3 = CountedK3()
    trainer.culled_march_normal_fn = k3
    trainer.step_fn = trainer._build_step()
    return k3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rig_dataset(device) -> RayDataset:
    """The 32 x 32 rig of parts (c)-(e) (__graft_entry__.py:109-111):
    targets clip(|rd|, 0, 1)."""
    ro, rd = (x.numpy() for x in create_camera_rays(32, 32, EYE, TARGET,
                                                     FOV, device="cpu"))
    return RayDataset(ro, rd, np.clip(np.abs(rd), 0, 1), device=device)


def dryrun_rank(device, out: str, n: int, parts: tuple = PARTS) -> dict:
    """The five parts (those of ``parts``, in their order; "union" only
    at model 2) on this rank of an initialized n-rank world → the summary,
    merged over the ranks (every rank returns it)."""
    data, model = mesh_shape(n)
    mesh = make_mesh(data=data, model=model)
    ds = rig_dataset(device)
    outputs = dict(scene_json=os.path.join(out, "scene.json"),
                   steps_dir=os.path.join(out, "steps"))
    ran, result = {}, dict(loss=None, culled_loss=None, driver_n=None)

    def part(name: str, run: Callable) -> None:
        if name not in parts:
            return
        before = build.launch_counts()
        t0 = time.perf_counter()
        graphs, k3 = run()
        _sync(device)
        after = build.launch_counts()
        launches = {fn.__name__: after[fn] - before[fn] for fn in after
                    if after[fn] != before[fn]}
        ran[name] = {
            "seconds": time.perf_counter() - t0, "graphs": graphs,
            "launches": launches,
            "k3_launches": launches.get(culled_march_normals.__name__, 0),
            "k3_calls": 0 if k3 is None else k3.calls}
        if k3 is not None:
            _require_k3(device, ran[name]["k3_launches"], k3, name)

    def dense():
        result["loss"], graphs = tiny_step(mesh, False, 0, device)
        return graphs, None

    def culled():
        result["culled_loss"], graphs = tiny_step(mesh, True, 1, device)
        return graphs, None

    def trainer(kw: dict, d: int, m: int, k3: bool):
        cfg = TrainConfig(batch_size=32 * d, **kw, **outputs)
        tr = DistributedTrainer(cfg, ds, data=d, model=m,
                                log=lambda s: None)
        counted = _with_k3(tr) if k3 else None
        padded, mask = tr.run()
        _require_finite(padded, None, "trainer")
        return tr, mask, counted

    def driver():
        tr, mask, _ = trainer(CFG_FULL, data, model, k3=False)
        if not float(tr.t_cache.max()) > 0.0:
            raise RuntimeError("driver: the warm cache was never written")
        result["driver_n"] = int(mask.sum())
        return tr._replays_graphs(), None

    def kernel():
        tr, _, k3 = trainer(CFG_K, n, 1, k3=True)
        return tr._replays_graphs(), k3

    def union():
        tr, _, k3 = trainer(CFG_FULL, data, model, k3=True)
        return tr._replays_graphs(), k3

    part("dense", dense)
    part("culled", culled)
    part("driver", driver)
    part("kernel", kernel)
    if model > 1:
        part("union", union)
    mine = {**result, "parts": ran}
    ranks = [None] * n
    dist.all_gather_object(ranks, mine)
    return _merge(ranks, n, data, model, device)


def _merge(ranks: list, n: int, data: int, model: int, device) -> dict:
    """One summary from every rank's: rank 0's losses (they are the
    replicated, data-averaged values), each part's slowest wall and the
    launches and K3 calls summed over the ranks."""
    first = ranks[0]
    parts = {}
    for name in first["parts"]:
        every = [r["parts"][name] for r in ranks]
        launches = collections.Counter()
        for p in every:
            launches.update(p["launches"])
        parts[name] = {"seconds": max(p["seconds"] for p in every),
                       "graphs": [p["graphs"] for p in every],
                       "launches": dict(launches),
                       "k3_launches": launches[culled_march_normals.__name__],
                       "k3_calls": sum(p["k3_calls"] for p in every)}
    return {"dryrun_multichip": n, "mesh": {"data": data, "model": model},
            "backend": dist.get_backend(), "device": _device_name(device),
            "loss": first["loss"], "culled_loss": first["culled_loss"],
            "driver_n": first["driver_n"],
            "kernel_in_sharded_step": "kernel" in parts,
            "union_kernel_msharded": "union" in parts, "parts": parts}


def _device_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


# --------------------------------------------------------------------------
# Config 4 at full width.


def c4_rank(device, out: str, n: int, data_dir: Optional[str],
            recipe: tuple = C4_RECIPE, steps: int = C4_STEPS,
            steady: int = STEADY_STEPS) -> list:
    """Parts (c)-(e) at ``recipe``'s width on this rank of an n-rank
    world: the knot set (rank 0 writes it with the port's generator when
    ``data_dir`` holds none), then on each mesh of ``c4_meshes(n)`` the
    DistributedTrainer with K3 for 1 stage x ``steps`` steps and
    ``steady`` timed steps from its trained state → one record per mesh,
    merged over the ranks."""
    from burn_raymarching_tpu_torch.tools import generate, run_c5

    data_dir = data_dir or os.path.join(out, "data_c4")
    args = run_c5.make_parser().parse_args(
        ["--out", out, "--data", data_dir, *recipe, "--stages", "1",
         "--steps", str(steps), "--skip-ceiling"])
    if dist.get_rank() == 0 and not os.path.exists(
            os.path.join(data_dir, "cameras.json")):
        generate.main(run_c5.generate_argv(
            data_dir, views=args.views, size=args.size, gt_n=args.gt_n,
            device=str(device)))
    dist.barrier()
    cfg = run_c5.build_config(args, data_dir)
    ds = build_dataset(cfg, device=device)
    records = []
    for data, model in c4_meshes(n):
        mine = c4_mesh(device, cfg, ds, data, model, steady)
        ranks = [None] * n
        dist.all_gather_object(ranks, mine)
        wall = max(r["wall_ms_per_step"] for r in ranks)
        records.append({
            "width": "c4", "mesh": [data, model], "ranks": ranks,
            "batch": cfg.batch_size, "steps_trained": steps,
            "steady_steps": steady, "rays_per_s": cfg.batch_size / wall * 1e3,
            "rays_per_s_per_card": cfg.batch_size / wall * 1e3 / n,
            "device": _device_name(device), "backend": dist.get_backend()})
    return records


def c4_mesh(device, cfg: TrainConfig, ds, data: int, model: int,
            steady: int) -> dict:
    """One mesh at full width on this rank: the trainer's run with K3,
    then ``steady`` steps of its step from the trained state, set up as
    run_stage sets up a stage, timed after WARMUP_STEPS (the capture among
    them) → this rank's figures (device figures None off the card)."""
    from burn_raymarching_tpu_torch.tools.device_time import profile_calls

    on_card = device.type == "cuda"
    tr = DistributedTrainer(cfg, ds, data=data, model=model,
                            log=lambda s: None)
    k3 = _with_k3(tr)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    launches = culled_march_normals.launches
    t0 = time.perf_counter()
    padded, mask = tr.run()
    _sync(device)
    train_s = time.perf_counter() - t0
    launches = culled_march_normals.launches - launches
    n_live = int(mask.sum())
    _require_finite(padded, None, f"c4 {data}x{model}")
    _require_k3(device, launches, k3, f"c4 {data}x{model}")

    stage = cfg.stages - 1
    params = tr._prepare_stage_params(unpad_params(padded, n_live))
    padded, mask = tr._place(*pad_params(params, tr._bucket(params.n)))
    fg, n_fg = tr._sample_fg
    runner = ChunkRunner(
        tr.step_fn, padded, make_optimizer(cfg, padded),
        lr_scale_tree(cfg, stage), stage, mask, tr.dataset.packed, fg, n_fg,
        tr._stage_generator(np.asarray([0, 1], np.uint32)),
        t_cache=tr.t_cache, clusters=tr._build_cluster_table(padded, mask),
        unroll=cfg.scan_unroll, graphs=tr._replays_graphs())
    runner.run(1, WARMUP_STEPS)
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    runner.run(WARMUP_STEPS + 1, steady)
    _sync(device)
    wall = (time.perf_counter() - t0) * 1e3 / steady
    rec = {"rank": dist.get_rank(), "graphs": tr._replays_graphs(),
           "train_seconds": train_s, "k3_launches_training": launches,
           "n_live": n_live, "loss": float(runner.loss),
           "wall_ms_per_step": wall, "device_busy_ms_per_step": None,
           "host_launches_per_step": None, "k3_ms_per_step": None,
           "nccl_ms_per_step": None, "peak_memory_gb": None}
    if on_card:
        first = WARMUP_STEPS + steady + 1
        prof = profile_calls(lambda i: runner.run(first + i, 1), steady)
        rec.update(
            device_busy_ms_per_step=prof["device_busy_ms_per_step"],
            host_launches_per_step=prof["host_launches_per_step"],
            k3_ms_per_step=prof["hand_kernels_ms_per_step"].get(
                "culled_march_kernel", 0.0),
            nccl_ms_per_step=prof["nccl_ms_per_step"],
            device_events_per_step=prof["device_events_per_step"],
            peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    runner.close()
    return rec


# --------------------------------------------------------------------------
# Ranks.


def _rank_main(rank: int, world: int, store: str, work: str, device: str,
               backend: str, timeout_s: float, fn: Callable,
               args: tuple) -> None:
    """One spawned rank: join the group through the FileStore, run
    ``fn(device, out, *args)`` with stdout on stderr, write its result
    (or its traceback) to <work>/rank<r>.pkl."""
    path = os.path.join(work, f"rank{rank}.pkl")
    try:
        dev = rank_device(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        init_distributed(dev, backend=backend, init_method=f"file://{store}",
                         world_size=world, rank=rank, timeout_s=timeout_s)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                result = fn(dev, os.path.join(work, "out"), *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(path, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:                                    # noqa: BLE001
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def spawn(n: int, fn: Callable, *args, device: str = "cuda",
          backend: str = "nccl", timeout: Optional[float] = None,
          root: Optional[str] = None) -> list:
    """``fn(device, out, *args)`` on n spawned ranks → their results in
    rank order. A fresh directory (under ``root``, else the system's
    temporary directory) holds the FileStore (a stale one hands new ranks
    old addresses and they hang) and the ranks' shared output directory;
    it is removed afterwards. When a rank fails the others are stopped,
    and the first failing rank's traceback is raised; so is a run that
    outlasts ``timeout`` (JOIN_TIMEOUT_S by default; no collective waits
    longer)."""
    import torch.multiprocessing as mp

    timeout = JOIN_TIMEOUT_S if timeout is None else timeout
    if root is not None:
        os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="dryrun_ranks_", dir=root)
    try:
        os.makedirs(os.path.join(work, "out"))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, os.path.join(work, "store"), work,
                                   device, backend,
                                   min(COLLECTIVE_TIMEOUT_S, timeout), fn,
                                   args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        results = []
        failed = [f"timed out after {timeout:.0f} s"] if timed_out else []
        for r, p in enumerate(procs):
            path = os.path.join(work, f"rank{r}.pkl")
            if not os.path.exists(path):
                failed.append(f"rank {r} wrote no result (exit code "
                              f"{p.exitcode})")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
        if failed:
            raise RuntimeError("; ".join(failed))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


def in_world(n: int, fn: Callable, *args, device: str = "cuda",
              backend: Optional[str] = None) -> list:
    """``fn(device, out, *args)`` on every rank of an n-rank world → rank
    0's result: in the world that exists (``torch.distributed.run``), in
    this process for n = 1 (a world of one, closed after), else on n
    spawned ranks."""
    backend = check_backend(n, device, backend)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"--n {n} in a world of "
                               f"{dist.get_world_size()} ranks")
        dev = rank_device(device, dist.get_rank())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        with tempfile.TemporaryDirectory() as out:
            return fn(dev, out, *args)
    if n > 1:
        return spawn(n, fn, *args, device=device, backend=backend)[0]
    dev = rank_device(device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(dev, backend=backend)
    try:
        with tempfile.TemporaryDirectory() as out:
            return fn(dev, out, *args)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda",
                     backend: Optional[str] = None,
                     parts: tuple = PARTS) -> dict:
    """The five parts, or those of ``parts``, on n ranks (``in_world``) →
    the summary (a loss, culled_loss or driver_n whose part did not run is
    None)."""
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)}; the parts are "
                         f"{PARTS}")
    resolve_device(device)
    return in_world(n, dryrun_rank, n, tuple(parts), device=device,
                    backend=backend)


def c4_slice(n: int, data_dir: Optional[str] = None, device: str = "cuda",
             backend: Optional[str] = None, recipe: tuple = C4_RECIPE,
             steps: int = C4_STEPS, steady: int = STEADY_STEPS) -> list:
    """Parts (c)-(e) at ``recipe``'s width (config 4's; the tests pass a
    tiny one) on n ranks → one record per mesh."""
    resolve_device(device)
    return in_world(n, c4_rank, n, data_dir, recipe, steps, steady,
                     device=device, backend=backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="ranks (default: the world under "
                         "torch.distributed.run, else 1)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--entry", action="store_true",
                    help="run the entry forward alone")
    ap.add_argument("--width", default="tiny", choices=["tiny", "c4"],
                    help="tiny: the JAX dry run's shapes; c4: parts (c)-(e) "
                         "at config 4's width, timed (the card only)")
    ap.add_argument("--data", default=None,
                    help="with --width c4: an existing config-4 knot set")
    args = ap.parse_args(argv)

    if args.entry:
        fn, fn_args = entry(args.device)
        with torch.no_grad():
            img = fn(*fn_args)
        finite = bool(torch.isfinite(img).all())
        print("entry forward:", tuple(img.shape), "finite:", finite,
              flush=True)
        return 0 if finite else 1
    if args.width == "c4" and args.device != "cuda":
        print("dryrun_multichip: --width c4 is the full-width measurement "
              "and needs the card", file=sys.stderr)
        return 2
    under_run = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    n = args.n or (int(os.environ["WORLD_SIZE"]) if under_run else 1)
    try:
        backend = check_backend(n, args.device, args.backend)
    except RuntimeError as e:
        print(f"dryrun_multichip: {e}", file=sys.stderr)
        return 2
    if under_run:
        rank = int(os.environ["RANK"])
        init_distributed(rank_device(args.device, rank),
                         backend=backend, timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            if args.width == "c4":
                out = c4_slice(n, args.data, args.device, backend)
            else:
                out = [dryrun_multichip(n, args.device, backend)]
    finally:
        if under_run:
            dist.destroy_process_group()
    if not under_run or rank == 0:
        for line in out:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

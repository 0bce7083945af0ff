"""The ``train_dp`` traffic kind: a user's whole training jobs back to back
on a data-parallel mesh of cards, through the program's normal entry for
it, ``DistributedTrainer(cfg, build_dataset(cfg), data=D, model=1).run()``.

One process per card. Rank 0 runs in the harness's own process on card 0
(so that the profiler, the program's tracer and the import check see it);
ranks 1 .. D - 1 are started here as ``python -m
benchmark.harness.train_dp --rank r ...`` on cards 1 .. D - 1 (on the CPU:
processes of a gloo world). They meet through a file store under
``TMPDIR``; the program's collectives run over NCCL between cards (gloo on
the CPU), and the harness's own agreement over a gloo group of its own.

Every rank runs what ``harness/train.py`` runs on one card, with its
pieces: set-up renders the dataset once (rank 0, before the ranks meet),
builds each rank's trainer, and drives the first ``check_steps`` steps of
a run from the seed one graph replay at a time (``check_steps``); the
same trainers then run jobs for the window (``window_jobs``), each rank
with a ``BoundaryProbe`` on the window's first stage boundary. Rank 0
alone decides when the window ends, at the first chunk end after
``--seconds`` and after the boundary's checked steps; every rank learns it
at that chunk end (one broadcast a chunk over the harness's group), so
that no rank is left waiting in a collective. Each rank then hands what it
kept to rank 0 through a file, and rank 0 computes the reference
(``reference/dp.py``: every rank's shard, sampler and warm cache, the mean
of the shard gradients, Adam, density control) and the numbers.

A rank that fails ends the run without a result: rank 0 watches the
others, and on a card, where a collective inside a replayed graph waits
without a timeout, it stops every rank and exits non-zero; a run that
outlives ``run_timeout_s`` ends the same way. Every collective of the
harness and of the program outside a graph is bounded by
``rank_timeout_s``.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import datetime
import gc
import importlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from benchmark.harness import checks, manifest, stats
from benchmark.harness.train import (
    REF_DTYPE,
    BoundaryProbe,
    StopWindow,
    TraceRun,
    Window,
    _on_cpu,
    _ref_config,
    boundary_numbers,
    build_config,
    check_steps,
    job_seed,
    program_boundary,
    runner_class,
    sync,
    window_jobs,
)
from benchmark.reference import data as ref_data
from benchmark.reference import density as ref_density
from benchmark.reference import dp as ref_dp
from benchmark.reference.generate import write_dataset
from benchmark.reference.scene import params_from_numpy, unpad_params

READINGS = ("control", "half_batch", "skip_merge", "skip_mean")


def data_ranks(cell) -> int:
    """The width of the configuration's data mesh (its model axis is 1)."""
    data, model = cell.config["deployment"]["mesh"]
    if model != 1:
        raise ValueError("the train_dp kind runs a data mesh (model 1)")
    return int(data)


class RankWindow(Window):
    """The window of one rank: rank 0's decision to end it, at a chunk end,
    reaches every rank through ``group``."""

    def __init__(self, seconds, traffic, traced, device, probe, group):
        super().__init__(seconds, traffic, traced, device, probe)
        self.group = group

    def after_chunk(self, n: int) -> None:
        stop = 0
        try:
            super().after_chunk(n)
        except StopWindow:
            stop = 1
        flag = torch.tensor([stop], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.group)
        if int(flag):
            if not stop:
                sync(self.device)
                self.t1 = time.perf_counter()
            raise StopWindow


def _params_gap(a: dict, b: dict) -> float:
    gap = 0.0
    for k in a:
        x, y = a[k].double(), b[k].double()
        if x.shape != y.shape:
            return math.inf
        if x.numel():
            gap = max(gap, float((x - y).abs().max()))
    return gap


def replica_gap(kept: list) -> float:
    """The largest difference between rank 0's parameters and any other
    rank's: after the checked steps, density control's answer at the
    boundary and after the next stage's checked steps."""
    gap = 0.0
    for other in kept[1:]:
        gap = max(gap, _params_gap(kept[0]["got"]["p3"], other["got"]["p3"]))
        pa, pb = kept[0]["probe"], other["probe"]
        for key in ("out", "p3"):
            if (key in pa) != (key in pb):
                return math.inf
            if key in pa:
                gap = max(gap, _params_gap(pa[key], pb[key]))
    return gap


def _rank(rank: int, world: int, spec: dict, seed: int, seconds: float,
          traced: bool, tmp: str, device, note) -> dict:
    """One rank's run: meet the others, set up, the checked steps, the
    window → what the rank kept (on the host), and rank 0's window."""
    from burn_raymarching_tpu_torch import config as prog_config
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )
    from burn_raymarching_tpu_torch.parallel.mesh import init_distributed
    from burn_raymarching_tpu_torch.train import loop, step_body

    config, traffic = spec["config"], spec["traffic"]
    data, model = config["deployment"]["mesh"]
    timeout = float(traffic["rank_timeout_s"])
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init_distributed(device, backend=backend,
                     init_method="file://" + os.path.join(tmp, "rendezvous"),
                     world_size=world, rank=rank, timeout_s=timeout)
    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout))
    note("ranks met")
    data_dir = os.path.join(tmp, "data")
    cfg = build_config(prog_config, config["train"], data_dir,
                       os.path.join(tmp, "out"), job_seed(seed, 0))
    dataset = loop.build_dataset(cfg, device=device)
    trainer = DistributedTrainer(cfg, dataset, data=data, model=model,
                                 log=lambda msg: None)
    note("dataset and trainer built")
    got = check_steps(trainer, loop, step_body, traffic["check_steps"],
                      note)
    note("checked steps run")

    probe = BoundaryProbe(traffic["check_steps"]) if cfg.stages > 1 else None
    if probe is not None:
        probe.wrap(trainer)
    win = RankWindow(seconds if rank == 0 else math.inf, traffic,
                     traced and rank == 0, device, probe, group)
    for method, name in (("run_stage", "stage"), ("prefill_t_cache",
                         "prefill"), ("_density_control", "density"),
                         ("save_preview", "preview"),
                         ("save_checkpoint", "checkpoint"),
                         ("_export_final", "export")):
        win.spans.wrap(trainer, method, name)
    base = loop.ChunkRunner
    loop.ChunkRunner = runner_class(base, win, cfg)
    dist.barrier(group=group)
    sync(device)
    win.t0 = time.perf_counter()
    setup_wall = time.time()
    jobs = 0
    try:
        for js in window_jobs(seed, traffic["job_pool"]):
            trainer.cfg = dataclasses.replace(cfg, seed=js)
            trainer.run()
            jobs += 1
    except StopWindow:
        pass
    finally:
        loop.ChunkRunner = base
    win.close_slice()
    losses = trainer.loss_history
    kept = {"got": got,
            "probe": ({**_on_cpu(probe.got), "seed": probe.seed}
                      if probe is not None else {}),
            "steps": win.steps,
            "failed": trainer._chunk * sum(
                1 for x in losses if not math.isfinite(x)),
            "peak": (torch.cuda.max_memory_allocated(device)
                     if torch.device(device).type == "cuda" else 0)}
    note(f"window closed: {win.steps} steps, {jobs} whole jobs")
    del trainer, dataset
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier(group=group)
    return {"kept": kept, "win": win, "cfg": cfg, "setup_wall": setup_wall}


def _die_with_parent() -> None:
    """Ask the kernel to end this process when its parent ends."""
    pr_set_pdeathsig = 1
    try:
        ctypes.CDLL("libc.so.6").prctl(pr_set_pdeathsig, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


class Ranks:
    """Ranks 1 .. world - 1, started and watched by rank 0. On a failed
    rank or past the deadline every rank is stopped; with ``hard`` (a
    card, where a collective in a replayed graph waits for ever) rank 0
    then exits non-zero at once."""

    def __init__(self, world: int, tmp: str, seed: int, device_type: str,
                 deadline_s: float, plant: str = "", hard: bool = False):
        self.tmp, self.hard = tmp, hard
        self.deadline = time.monotonic() + deadline_s
        self.logs = [os.path.join(tmp, f"rank{r}.log")
                     for r in range(world)]
        self.procs = {}
        for r in range(1, world):
            with open(self.logs[r], "w") as log:
                self.procs[r] = subprocess.Popen(
                    [sys.executable, "-m", "benchmark.harness.train_dp",
                     "--rank", str(r), "--world", str(world), "--tmp", tmp,
                     "--seed", str(seed), "--device", device_type,
                     "--plant", plant],
                    cwd=manifest.ROOT, stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL)
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()

    def _tail(self, r: int, n: int = 4000) -> str:
        try:
            with open(self.logs[r]) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def _watcher(self) -> None:
        while not self._done.wait(0.5):
            for r, p in self.procs.items():
                rc = p.poll()
                if rc not in (None, 0):
                    self._fail(f"rank {r} exited with {rc}:\n"
                               + self._tail(r))
                    return
            if time.monotonic() > self.deadline:
                self._fail("the run outlived its run_timeout_s")
                return

    def _fail(self, why: str) -> None:
        print(f"no result: {why}", file=sys.stderr, flush=True)
        self.kill()
        if self.hard:
            shutil.rmtree(self.tmp, ignore_errors=True)
            os._exit(4)

    def kill(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()

    def join(self, timeout_s: float) -> None:
        """Wait for every rank to exit → RuntimeError where one fails or
        outlives ``timeout_s``."""
        end = time.monotonic() + timeout_s
        for r, p in self.procs.items():
            try:
                rc = p.wait(max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "no exit"
            if rc != 0:
                self.kill()
                raise RuntimeError(f"rank {r}: {rc}\n{self._tail(r)}")
        self._done.set()

    def close(self) -> None:
        self._done.set()
        self.kill()


def _kept_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"rank{rank}.pt")


def run(cell, seed: int, seconds: float, traced: bool, tmp: str,
        device, note=lambda what: None, plant: str = "") -> dict:
    """One run of a data-parallel training cell → the harness's result
    fields. ``plant`` ("module:function") plants a fault in ranks 1 ..
    D - 1 (the caller plants it in its own process): the CPU tests."""
    data = data_ranks(cell)
    traffic = cell.traffic
    spec = {"config": cell.config, "traffic": traffic, "seconds": seconds}
    with open(os.path.join(tmp, "cell.json"), "w") as f:
        json.dump(spec, f)
    kind = torch.device(device).type
    ranks = Ranks(data, tmp, seed, kind, float(traffic["run_timeout_s"]),
                  plant=plant, hard=kind == "cuda")
    try:
        data_dir = os.path.join(tmp, "data")
        write_dataset(data_dir, cell.config["dataset"], device)
        note("dataset rendered")
        mine = _rank(0, data, spec, seed, seconds, traced, tmp, device,
                     note)
        dist.destroy_process_group()
        ranks.join(float(traffic["rank_timeout_s"]))
    except BaseException:
        ranks.close()
        if kind == "cuda":
            traceback.print_exc()
            print("no result: rank 0 failed", file=sys.stderr, flush=True)
            shutil.rmtree(tmp, ignore_errors=True)
            os._exit(4)
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    kept = [mine["kept"]] + [torch.load(_kept_path(tmp, r),
                                        weights_only=False)
                             for r in range(1, data)]
    win, cfg = mine["win"], mine["cfg"]
    result = {"attempted": win.steps, "failed": kept[0]["failed"],
              "setup_wall": mine["setup_wall"],
              "memory_peak_bytes": max(k["peak"] for k in kept),
              "metrics": {"train_rays_per_s": stats.rate(
                  win.steps * cfg.batch_size, win.t1 - win.t0)}}
    if any(k["steps"] != win.steps for k in kept):
        raise RuntimeError(f"the ranks stopped at different steps: "
                           f"{[k['steps'] for k in kept]}")
    note(f"every rank stopped at step {win.steps} of the window; peak "
         f"memory by rank {[k['peak'] for k in kept]} bytes")

    got = dict(kept[0]["got"])
    got["draws"] = [d for k in kept for d in k["got"]["draws"]]
    rows = ref_data.Rows(_ref_config(cell, data_dir, tmp, job_seed(seed, 0)),
                         device)
    n = traffic["check_steps"]
    numbers = checks.compare_train(got, reference_run(
        cell, data_dir, tmp, job_seed(seed, 0), n, device, rows=rows))
    probe = kept[0]["probe"]
    if "in" in probe:
        ref_b = reference_boundary(cell, data_dir, tmp, probe["seed"],
                                   probe["in"], n, device, rows=rows)
        numbers.update(boundary_numbers(probe, ref_b))
        note(f"first boundary: N {probe['event']['n_before']} -> "
             f"{probe['event']['n_after']}; next stage's losses "
             f"{probe['losses']}, reference's {ref_b['losses']}")
    numbers["replica_gap"] = replica_gap(kept)
    note("reference run")
    result["numbers"] = numbers
    if traced:
        # Rank 0's window, trace and records, and the data axis's width.
        result["trace"] = TraceRun(win, cfg)
        result["trace"].ranks = data
    return result


def _group(cfg):
    return cfg.cull_cluster_group if cfg.cluster_repulsion else None


def reference_run(cell, data_dir: str, tmp: str, seed: int, n_steps: int,
                  device, dtype=REF_DTYPE, fault: str | None = None,
                  rows=None) -> dict:
    """The checked steps of a run's first stage in the reference's
    data-parallel step (``reference/dp.py``), from its own copy of the
    inputs."""
    data = data_ranks(cell)
    cfg = _ref_config(cell, data_dir, tmp, seed)
    rows = rows if rows is not None else ref_data.Rows(cfg, device)
    padded, mask = ref_data.stage_start_params(cfg, device)
    live = unpad_params(padded, int(mask.sum()))
    padded, mask, clusters = ref_dp.stage_table(live, _group(cfg), dtype)
    return ref_dp.dp_steps(cfg, rows, padded, mask, clusters, 0, n_steps,
                           data, device, dtype, fault)


def reference_boundary(cell, data_dir: str, tmp: str, seed: int,
                       state: dict, n_steps: int, device, dtype=REF_DTYPE,
                       fault: str | None = None, rows=None) -> dict:
    """A stage boundary in the reference, from the program's state at the
    end of the stage before it (what ``BoundaryProbe`` keeps of density
    control's input): density control, then the next stage's first
    ``n_steps`` data-parallel steps from the table it returned. ``fault``
    plants "skip_merge" at the boundary, or a fault of the step."""
    data = data_ranks(cell)
    cfg = _ref_config(cell, data_dir, tmp, seed)
    rows = rows if rows is not None else ref_data.Rows(cfg, device)
    live = {k: v.float().cpu().numpy() for k, v in state["live"].items()}
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = copy.deepcopy(state["rng"])
    centers, colors, radii, counts_ = ref_density.prune_and_split(
        live["centers"], live["colors"], live["radii"],
        state["init_centers"], state["stage"], cfg.stages, rng, cfg.density,
        merge=fault != "skip_merge")
    counts_["n_after"] = int(centers.shape[0])
    dens = {"centers": centers, "colors": colors, "radii": radii,
            "light_dir": live["light_dir"], "ambient": live["ambient"]}
    padded, mask, clusters = ref_dp.stage_table(
        params_from_numpy(dens, device=device), _group(cfg), dtype)
    out = ref_dp.dp_steps(cfg, rows, padded, mask, clusters,
                          state["stage"] + 1, n_steps, data, device, dtype,
                          fault if fault in ref_dp.FAULTS else None)
    out["density"] = {k: dens[k] for k in ("centers", "colors", "radii")}
    out["counts"] = counts_
    return out


def readings(cell, seed: int, tmp: str, device, kinds: list) -> dict:
    """The control's and the planted faults' numbers on ``seed``: the
    reference (float64) in the program's place, in bfloat16 ("control"),
    with half of each rank's batch left out ("half_batch"), with no mean
    over the data axis (rank 0's replica stepping on its own shard:
    "skip_mean"), or at the boundary without density control's merge
    ("skip_merge"), against the reference. The boundary starts from the
    one-card program's first stage of the same recipe run from the seed
    (the readings compare the reference with itself)."""
    data_dir = os.path.join(tmp, "data")
    write_dataset(data_dir, cell.config["dataset"], device)
    s0 = job_seed(seed, 0)
    n = cell.traffic["check_steps"]
    rows = ref_data.Rows(_ref_config(cell, data_dir, tmp, s0), device)
    ref = reference_run(cell, data_dir, tmp, s0, n, device, rows=rows)
    boundary = cell.config["train"]["stages"] > 1
    if boundary:
        bs, state = program_boundary(cell, seed, data_dir, tmp, device)
        ref_b = reference_boundary(cell, data_dir, tmp, bs, state, n, device,
                                   rows=rows)
    out = {}
    for kind in kinds:
        if kind not in READINGS:
            raise ValueError(f"no reading {kind!r} for a data-parallel "
                             f"training cell")
        dtype = torch.bfloat16 if kind == "control" else REF_DTYPE
        fault = None if kind == "control" else kind
        out[kind] = {}
        if kind != "skip_merge":
            other = reference_run(cell, data_dir, tmp, s0, n, device,
                                  dtype=dtype, fault=fault, rows=rows)
            out[kind] = checks.compare_train(
                {k: v for k, v in other.items() if k != "draws"}, ref)
        if boundary:
            other_b = reference_boundary(cell, data_dir, tmp, bs, state, n,
                                         device, dtype=dtype, fault=fault,
                                         rows=rows)
            other_b["out"] = other_b["density"]
            other_b["event"] = other_b["counts"]
            out[kind].update(boundary_numbers(other_b, ref_b))
    return out


# --------------------------------------------------------------------------
# Ranks 1 .. D - 1.


def _child(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of a train_dp run")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--tmp", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    p.add_argument("--plant", default="")
    args = p.parse_args(argv)
    with open(os.path.join(args.tmp, "cell.json")) as f:
        spec = json.load(f)
    if args.plant:
        mod, fn = args.plant.split(":")
        getattr(importlib.import_module(mod), fn)(setattr)
    device = (torch.device("cuda", args.rank) if args.device == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)    # D ranks share the host's cores

    def note(what: str) -> None:
        print(f"[rank {args.rank}] {what} at {time.time():.2f}",
              file=sys.stderr, flush=True)

    mine = _rank(args.rank, args.world, spec, args.seed, spec["seconds"],
                 False, args.tmp, device, note)
    torch.save(mine["kept"], _kept_path(args.tmp, args.rank))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    _die_with_parent()
    sys.exit(_child())

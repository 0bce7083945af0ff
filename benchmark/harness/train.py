"""The ``train`` traffic kind: a user's whole training job, run again and
again for the window, through the program's normal entry
``Trainer(cfg, build_dataset(cfg)).run()``.

Set-up renders the configuration's dataset from this folder's copy of the
ground-truth renderer into a directory under ``TMPDIR``, builds the dataset
and one ``Trainer``, and drives that trainer through the first
``check_steps`` steps of a run from the seed, through ``run`` →
``run_stage`` → ``ChunkRunner`` as the window drives it; what those steps
produced is kept for the check. The same trainer then runs jobs for the
window (``window_jobs``), each from its seeded init, with its stage
boundaries (prefill, cluster tables, graph capture, density
control, previews, checkpoints, export), and the window ends at the first
100-step chunk end after ``--seconds`` (and after the first boundary's
checked steps, below). The window's first stage boundary is kept for the
check too (``BoundaryProbe``): what density control read and returned,
and the first ``check_steps`` steps of the stage after it, which the
window's own runner drives one graph replay at a time. After the window
the reference repeats the checked steps of the first stage from its own
copy of the inputs, and the boundary from the program's state at the end
of the stage before it: its own density control, then the next stage's
prefill, cluster tables and steps from what that returned.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import math
import os
import time

import numpy as np
import torch

from benchmark.harness import checks, counts, devtrace, stats
from benchmark.reference import adam as ref_adam
from benchmark.reference import config as ref_config
from benchmark.reference import data as ref_data
from benchmark.reference import density as ref_density
from benchmark.reference import loss as ref_loss
from benchmark.reference import step as ref_step
from benchmark.reference.culling import build_clusters
from benchmark.reference.generate import write_dataset
from benchmark.reference.padding import bucket_size
from benchmark.reference.scene import pad_params, params_from_numpy

LEAVES = checks.LEAVES
# The precision the reference computes in. float32 is not enough: on some
# trained states the plain float32 step's first gradient lies percents
# from the float64 one, where the program's kernels agree with float64.
REF_DTYPE = torch.float64


class StopWindow(Exception):
    """Raised at the first chunk end after the window's deadline."""


class CheckDone(Exception):
    """Raised once the checked steps have run."""


def job_seed(seed: int, job: int) -> int:
    """A 31-bit training seed drawn from ``seed`` and ``job``."""
    return int(np.random.SeedSequence([seed, job]).generate_state(1)[0]
               & 0x7FFFFFFF)


def window_jobs(seed: int, pool: int):
    """Endless seeds of the window's jobs: the traffic's fixed pool of
    ``pool`` job seeds, played again and again, each time in an order
    drawn from ``seed``, so that every run trains the same jobs in another
    order (a job's seed decides how density control grows its scene, and
    so what the job costs)."""
    seeds = [job_seed(0x5EED, i) for i in range(pool)]
    rng = np.random.default_rng([seed, 0x10B5])
    while True:
        for i in rng.permutation(pool):
            yield seeds[i]


def build_config(classes, spec: dict, data_dir: str, out_dir: str,
                 seed: int):
    """The TrainConfig of a configuration file's ``train`` section, with
    the run's paths and seed; ``classes`` is a module holding TrainConfig,
    RenderConfig, LossConfig and DensityConfig (the program's, or the
    reference's copy)."""
    fields = dict(spec)
    groups = {"render": classes.RenderConfig, "loss": classes.LossConfig,
              "density": classes.DensityConfig}
    for key, cls in groups.items():
        if key in fields:
            fields[key] = cls(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in fields[key].items()})
    for k, v in list(fields.items()):
        if isinstance(v, list):
            fields[k] = tuple(v)
    if fields.get("init_points"):
        fields["init_points"] = os.path.join(data_dir, fields["init_points"])
    fields.update(
        seed=seed, cameras_json=os.path.join(data_dir, "cameras.json"),
        data_dir=data_dir, scene_json=os.path.join(out_dir, "scene.json"),
        steps_dir=os.path.join(out_dir, "steps"),
        checkpoint_dir=(os.path.join(out_dir, "checkpoints")
                        if fields.get("checkpoint_dir") else ""),
        metrics_jsonl=None)
    return classes.TrainConfig(**fields)


def _leaf_copies(params) -> dict:
    return {k: getattr(params, k).detach().clone() for k in LEAVES}


def _moments(runner) -> dict:
    """The gradient as Adam's first moment holds it after one step (zero
    where the optimizer holds no state: it never stepped)."""
    b1 = runner.opt.param_groups[0]["betas"][0]
    out = {}
    for k in LEAVES:
        p = getattr(runner.params, k)
        m = runner.opt.state.get(p, {}).get("exp_avg")
        out[k] = (torch.zeros_like(p) if m is None
                  else m.detach().clone() / (1.0 - b1))
    return out


def _on_cpu(got: dict) -> dict:
    """``got`` with every tensor of its values (dicts and lists of
    tensors) moved to the host."""
    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x
    return {k: ({kk: cpu(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else
                [cpu(x) for x in v] if isinstance(v, list) else v)
            for k, v in got.items()}


def check_steps(trainer, loop, step_body, n_steps: int,
                note=lambda what: None) -> dict:
    """Run the first ``n_steps`` steps of ``trainer.run()`` one graph
    replay at a time and keep what they produced: each step's loss, its
    drawn batch indices, the stage-start parameters, the gradient as Adam
    holds it after the first step and the parameters after the last."""
    got = {"losses": [], "draws": []}
    base = loop.ChunkRunner
    draw = step_body.sample_step_indices
    last = {}

    def sample(*args, **kwargs):
        idx = draw(*args, **kwargs)
        if "idx" not in last:
            last["idx"] = torch.empty_like(idx)
        last["idx"].copy_(idx)
        return idx

    class CheckRunner(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            got["p0"] = _leaf_copies(self.params)
            note("checked run: first stage set up")

        def run(self, first, n):
            if self.unroll != 1:
                raise ValueError("the check reads every step: scan_unroll "
                                 "must be 1")
            for s in range(first, first + n_steps):
                super().run(s, 1)
                got["losses"].append(float(self.loss))
                note(f"checked run: step {s}")
                got["draws"].append(last["idx"].clone())
                if s == first:
                    got["grad"] = _moments(self)
            got["p3"] = _leaf_copies(self.params)
            raise CheckDone

    loop.ChunkRunner, step_body.sample_step_indices = CheckRunner, sample
    try:
        trainer.run()
    except CheckDone:
        pass
    finally:
        loop.ChunkRunner, step_body.sample_step_indices = base, draw
    sync(trainer.device)
    return _on_cpu(got)


class BoundaryProbe:
    """The first stage boundary of the window, kept for the check: what the
    program's density control read (the stage's live parameters, its
    stage-start centers, the stage, the host generator's state) and
    returned (the next stage's parameters and its counts), and the first
    ``n_steps`` steps of the next stage, run by the window's own runner
    one graph replay at a time (each step's loss, the gradient as Adam
    holds it after the first, the parameters at the stage's start and
    after the last)."""

    def __init__(self, n_steps: int):
        self.n_steps = n_steps
        self.state = "density"          # → "steps" → "done"
        self.seed = None
        self.got = {"losses": []}

    def wrap(self, trainer) -> None:
        """Route ``trainer._density_control`` through the probe."""
        inner = trainer._density_control

        def density(padded, mask, n_live, stage_init_centers, stage, rng):
            if self.state != "density":
                return inner(padded, mask, n_live, stage_init_centers,
                             stage, rng)
            self.seed = trainer.cfg.seed
            live = {k: getattr(padded, k).detach()[:n_live].cpu()
                    for k in ("centers", "colors", "radii")}
            live.update({k: getattr(padded, k).detach().cpu()
                         for k in ("light_dir", "ambient")})
            self.got["in"] = {
                "live": live, "stage": stage,
                "init_centers": np.array(stage_init_centers, copy=True),
                "rng": copy.deepcopy(rng.bit_generator.state)}
            out = inner(padded, mask, n_live, stage_init_centers, stage,
                        rng)
            self.got["out"] = {k: getattr(out, k).detach().cpu()
                               for k in LEAVES}
            self.got["event"] = dict(trainer.events[-1])
            self.state = "steps"
            return out

        trainer._density_control = density

    def starts(self, runner) -> bool:
        """Whether ``runner`` (just built) runs the probed stage."""
        if self.state != "steps" or "p0" in self.got:
            return False
        if runner.unroll != 1:
            raise ValueError("the check reads every step: scan_unroll "
                             "must be 1")
        self.got["p0"] = _leaf_copies(runner.params)
        return True

    def record(self, run_steps, runner, first: int, n: int) -> int:
        """Run the checked steps of the chunk ``first``.. through
        ``run_steps(first, n)`` one at a time → how many were run."""
        k = min(self.n_steps, n)
        for s in range(first, first + k):
            run_steps(s, 1)
            self.got["losses"].append(float(runner.loss))
            if s == first:
                self.got["grad"] = _moments(runner)
        self.got["p3"] = _leaf_copies(runner.params)
        self.state = "done"
        return k


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window of a training cell."""

    def __init__(self, seconds: float, traffic: dict, traced: bool,
                 device, probe: BoundaryProbe | None = None):
        self.device = device
        self.probe = probe
        self.seconds = seconds
        self.traced = traced
        self.trace_from = traffic["trace_from_step"]
        self.trace_len = traffic["trace_steps"]
        self.spans = devtrace.Spans(traced)
        self.slice = devtrace.Slice() if traced else None
        self.slice_state = "before"
        self.steps = 0
        self.t0 = self.t1 = None
        # Per-step sums over the traced slice: live primitives, valid
        # (tile, slot) entries of the culled tables, repulsion pairs.
        self.n_live = 0
        self.rep_pairs = 0.0
        self.slice_steps = 0
        self.slice_live = 0.0
        self.slice_rep_pairs = 0.0
        self.valid = None
        self.valid_at_start = 0

    def after_chunk(self, n: int) -> None:
        self.steps += n
        now = time.perf_counter()
        if self.slice_state == "on":
            self.slice_steps += n
            self.slice_live += n * self.n_live
            self.slice_rep_pairs += n * self.rep_pairs
            if self.slice_steps >= self.trace_len:
                with self.spans.span("pause", annotate=False):
                    self.valid_slice = self._valid_now() - self.valid_at_start
                    self.slice.stop()
                self.slice_state = "done"
        elif (self.slice_state == "before" and self.traced
              and self.steps >= self.trace_from):
            with self.spans.span("pause", annotate=False):
                self.valid_at_start = self._valid_now()
                self.slice.start()
            self.slice_state = "on"
        if now >= self.t0 + self.seconds and (
                self.probe is None or self.probe.state == "done"):
            sync(self.device)
            self.t1 = time.perf_counter()
            raise StopWindow

    def close_slice(self) -> None:
        """Stop a slice that the window's end cut short."""
        if self.slice_state == "on":
            self.valid_slice = self._valid_now() - self.valid_at_start
            self.slice.stop()
            self.slice_state = "done"

    def _valid_now(self) -> int:
        return 0 if self.valid is None else int(self.valid)


def runner_class(base, win: Window, cfg):
    """The program's ChunkRunner, with the window's bookkeeping at each
    chunk end (and, traced, a span around each chunk)."""

    class WindowRunner(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.probed = win.probe is not None and win.probe.starts(self)
            if win.traced:
                win.n_live = int(self.mask.sum())
                win.rep_pairs = (counts.cluster_repulsion_pairs(
                    win.n_live, cfg.cull_cluster_group, 8)
                    if cfg.cluster_repulsion else float(win.n_live) ** 2)

        def run(self, first, n):
            with win.spans.span("chunk"):
                done = 0
                if self.probed and win.probe.state == "steps":
                    done = win.probe.record(super().run, self, first, n)
                if n > done:
                    super().run(first + done, n - done)
            win.after_chunk(n)

    return WindowRunner


def count_valid(step_body, win: Window, device):
    """Count the valid entries of every culled table the step builds, into
    a device counter that a captured step adds to on each replay (traced
    runs only) → the function to put back."""
    orig = step_body.culled_tables
    win.valid = torch.zeros((), dtype=torch.int64, device=device)

    def counted(*args, **kwargs):
        out = orig(*args, **kwargs)
        win.valid.add_(out[1].sum())
        return out

    step_body.culled_tables = counted
    return orig


def run(cell, seed: int, seconds: float, traced: bool, tmp: str,
        device, note=lambda what: None) -> dict:
    """One run of a training cell → the harness's result fields.
    ``note(what)`` marks the progress of set-up and check."""
    from burn_raymarching_tpu_torch import config as prog_config
    from burn_raymarching_tpu_torch.train import loop, step_body

    note("program imported")
    spec, traffic = cell.config, cell.traffic
    data_dir = os.path.join(tmp, "data")
    write_dataset(data_dir, spec["dataset"], device)
    note("dataset rendered")
    cfg = build_config(prog_config, spec["train"], data_dir,
                       os.path.join(tmp, "out"), job_seed(seed, 0))
    dataset = loop.build_dataset(cfg, device=device)
    trainer = loop.Trainer(cfg, dataset, log=lambda msg: None)
    note("dataset and trainer built")
    got = check_steps(trainer, loop, step_body, traffic["check_steps"],
                      note)
    note("checked steps run")

    probe = BoundaryProbe(traffic["check_steps"]) if cfg.stages > 1 else None
    if probe is not None:
        probe.wrap(trainer)
    win = Window(seconds, traffic, traced, device, probe)
    for method, name in (("run_stage", "stage"), ("prefill_t_cache",
                         "prefill"), ("_density_control", "density"),
                         ("save_preview", "preview"),
                         ("save_checkpoint", "checkpoint"),
                         ("_export_final", "export")):
        win.spans.wrap(trainer, method, name)
    base = loop.ChunkRunner
    put_back = (count_valid(step_body, win, device)
                if traced and cfg.use_culling else None)
    loop.ChunkRunner = runner_class(base, win, cfg)
    sync(device)
    win.t0 = time.perf_counter()
    setup_wall = time.time()
    jobs, job_ends = 0, []
    try:
        for js in window_jobs(seed, traffic["job_pool"]):
            trainer.cfg = dataclasses.replace(cfg, seed=js)
            trainer.run()
            jobs += 1
            job_ends.append(time.perf_counter())
    except StopWindow:
        pass
    finally:
        loop.ChunkRunner = base
        if put_back is not None:
            step_body.culled_tables = put_back
    win.close_slice()
    losses = trainer.loss_history
    failed = trainer._chunk * sum(
        1 for x in losses if not math.isfinite(x))
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    result = {"attempted": win.steps, "failed": failed,
              "setup_wall": setup_wall, "memory_peak_bytes": peak,
              "metrics": {"train_rays_per_s": stats.rate(
                  win.steps * cfg.batch_size, win.t1 - win.t0)}}
    del trainer, dataset
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    note(f"window closed: {win.steps} steps, {jobs} whole jobs, ending at "
         f"{[round(t - win.t0, 2) for t in job_ends]} s")
    rows = ref_data.Rows(build_config(
        ref_config, spec["train"], data_dir, os.path.join(tmp, "out"),
        job_seed(seed, 0)), device)
    ref = reference_run(cell, data_dir, tmp, job_seed(seed, 0),
                        traffic["check_steps"], device, rows=rows)
    numbers = checks.compare_train(got, ref)
    if probe is not None:
        got_b = _on_cpu(probe.got)
        ref_b = reference_boundary(cell, data_dir, tmp, probe.seed,
                                   got_b["in"], traffic["check_steps"],
                                   device, rows=rows)
        numbers.update(boundary_numbers(got_b, ref_b))
        ev = got_b["event"]
        note(f"first boundary: N {ev['n_before']} -> {ev['n_after']}; next "
             f"stage's losses {got_b['losses']}, reference's "
             f"{ref_b['losses']}")
    note("reference run")
    result["numbers"] = numbers
    if traced:
        result["trace"] = TraceRun(win, cfg)
    return result


def boundary_numbers(prog: dict, ref: dict) -> dict:
    """The check's numbers of the window's first boundary: density
    control's (``checks.compare_density``) and the next stage's checked
    steps (``checks.compare_train``, named ``<number>.s1``)."""
    out = checks.compare_density(prog["out"], prog["event"],
                                 ref["density"], ref["counts"])
    out.update({f"{k}.s1": v for k, v in checks.compare_train(
        {k: prog[k] for k in ("losses", "grad", "p0", "p3")}, ref).items()})
    return out


class TraceRun:
    """What a per-layer reader of a training cell reads."""

    def __init__(self, win: Window, cfg):
        self.spans = win.spans
        self.window = (win.t0, win.t1)
        self.events = win.slice.events if win.slice_state == "done" else None
        self.slice_steps = win.slice_steps
        self.slice_live = win.slice_live
        self.slice_rep_pairs = win.slice_rep_pairs
        self.slice_valid = getattr(win, "valid_slice", 0)
        self.batch = cfg.batch_size
        self.tile = cfg.cull_tile
        self.culled = cfg.use_culling
        self.march_steps = (cfg.warm_steps if cfg.warm_start
                            else cfg.render.march_steps)
        self.peaks = counts.card_peaks()

    def march_pairs(self) -> float:
        """(ray, primitive) pairs the steps' march visits over the slice:
        valid table entries of the culled path, live slots of the dense."""
        if self.culled:
            return float(self.tile) * self.slice_valid
        return float(self.batch) * self.slice_live

    def step_work(self) -> counts.Work:
        """The least work of the slice's steps (counts.py)."""
        pairs = self.march_pairs()
        return (counts.march(pairs, self.march_steps)
                + counts.shade_fwd(pairs)
                + counts.repulsion_fwd(self.slice_rep_pairs)
                + counts.repulsion_bwd(self.slice_rep_pairs))


def _ref_config(cell, data_dir: str, tmp: str, seed: int):
    cfg = build_config(ref_config, cell.config["train"], data_dir,
                       os.path.join(tmp, "out"), seed)
    ref_step.check_config(cfg)
    return cfg


def reference_steps(cfg, rows, padded, mask, stage: int, n_steps: int,
                    device, dtype=REF_DTYPE, fault: str | None = None
                    ) -> dict:
    """The first ``n_steps`` steps of ``stage`` in the reference, from the
    stage-start parameters ``padded`` → each step's loss and drawn
    indices, the parameters at the start (``p0``) and after the last step
    (``p3``) and the gradient as Adam holds it after the first step. Like
    the program's stage it prefills the warm start's cache (here: of the
    drawn tiles) and builds the cluster tables from ``padded``, with an
    optimizer of its own. ``fault="half_batch"`` takes the loss over half
    of each batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = ref_data.stage_generator(cfg.seed, stage, device)
    draws = [ref_step.draw_indices(cfg, gen, stage, s, rows.n, rows.fg_pool,
                                   rows.n_fg) for s in range(1, n_steps + 1)]
    packed = rows.packed.to(dtype)
    t_cache = None
    if cfg.warm_start:
        t_cache = torch.zeros((rows.n,), dtype=dtype, device=device)
        tiles = torch.unique(torch.cat(draws) // cfg.cull_tile)
        k0 = ref_data.anneal_k(cfg, stage, 1)
        per = cfg.batch_size // cfg.cull_tile
        for i in range(0, tiles.numel(), per):
            pix = (tiles[i:i + per, None] * cfg.cull_tile + torch.arange(
                cfg.cull_tile, device=device)[None, :]).reshape(-1)
            t_cache[pix] = ref_step.cold_march_tiles(
                cfg, packed[pix, 0:3].contiguous(),
                packed[pix, 3:6].contiguous(), padded, mask, k0)
    clusters = static = None
    if cfg.cluster_repulsion:
        clusters = build_clusters(
            padded.centers.detach().float().cpu().numpy(),
            mask=mask.cpu().numpy(), group=cfg.cull_cluster_group,
            device=device)
        static = ref_loss.build_repulsion_static(padded.centers, clusters,
                                                 mask)
    leaves = {k: getattr(padded, k) for k in LEAVES}
    opt = ref_adam.PlainAdam(leaves, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
                             cfg.weight_decay, cfg.weight_decay_mode)
    scales = ref_step.lr_scale_tree(cfg, stage)
    keep = slice(0, cfg.batch_size // 2) if fault == "half_batch" else None
    out = {"losses": [], "draws": [d.cpu() for d in draws],
           "p0": {k: v.detach().clone().double().cpu()
                  for k, v in leaves.items()}}
    for s in range(1, n_steps + 1):
        for p in leaves.values():
            p.grad = None
        loss, lr = ref_step.step_loss(cfg, padded, stage, s, mask, packed,
                                      draws[s - 1], t_cache, clusters,
                                      static, keep=keep)
        loss.backward()
        opt.step({k: lr * scales[k] for k in LEAVES})
        out["losses"].append(float(loss.detach()))
        if s == 1:
            out["grad"] = {k: opt.moment_grad(k).detach().double().cpu()
                           for k in LEAVES}
    out["p3"] = {k: v.detach().clone().double().cpu()
                 for k, v in leaves.items()}
    return out


def reference_run(cell, data_dir: str, tmp: str, seed: int, n_steps: int,
                  device, dtype=REF_DTYPE, fault: str | None = None,
                  rows=None) -> dict:
    """The checked steps of a run's first stage again, in the reference,
    from its own copy of the inputs → what ``check_steps`` keeps.
    ``dtype`` computes it in another precision (the control); ``fault``
    plants a fault ("half_batch")."""
    cfg = _ref_config(cell, data_dir, tmp, seed)
    rows = rows if rows is not None else ref_data.Rows(cfg, device)
    padded, mask = ref_data.stage_start_params(cfg, device, dtype)
    return reference_steps(cfg, rows, padded, mask, 0, n_steps, device,
                           dtype, fault)


def reference_boundary(cell, data_dir: str, tmp: str, seed: int,
                       state: dict, n_steps: int, device,
                       dtype=REF_DTYPE, fault: str | None = None,
                       rows=None) -> dict:
    """A stage boundary in the reference, from the program's state at the
    end of the stage before it (``state``: what ``BoundaryProbe`` keeps of
    density control's input): the reference's own density control, then
    the first ``n_steps`` steps of the next stage from what it returned
    (``reference_steps``) → those steps' record, with ``density`` (the
    returned raw parameters, as NumPy) and ``counts``. ``fault`` plants
    "skip_merge" (density control without its merge) or "half_batch"."""
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
    params = params_from_numpy(dens, device=device)
    padded, mask = pad_params(params, bucket_size(params.n))
    out = reference_steps(cfg, rows, ref_data.as_dtype(padded, dtype), mask,
                          state["stage"] + 1, n_steps, device, dtype,
                          fault if fault == "half_batch" else None)
    out["density"] = {k: dens[k] for k in ("centers", "colors", "radii")}
    out["counts"] = counts_
    return out


def program_boundary(cell, seed: int, data_dir: str, tmp: str, device
                     ) -> tuple[int, dict]:
    """Run the program's first stage from the seed to its density control
    → (the job's seed, what ``BoundaryProbe`` keeps of density control's
    input)."""
    from burn_raymarching_tpu_torch import config as prog_config
    from burn_raymarching_tpu_torch.train import loop

    s0 = job_seed(seed, 0)
    cfg = build_config(prog_config, cell.config["train"], data_dir,
                       os.path.join(tmp, "out"), s0)
    trainer = loop.Trainer(cfg, loop.build_dataset(cfg, device=device),
                           log=lambda msg: None)
    probe = BoundaryProbe(0)
    probe.wrap(trainer)
    probed = trainer._density_control

    def stop(*args, **kwargs):
        probed(*args, **kwargs)
        raise CheckDone

    trainer._density_control = stop
    try:
        trainer.run()
    except CheckDone:
        pass
    state = _on_cpu(probe.got)["in"]
    del trainer, probe, probed
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return s0, state


def readings(cell, seed: int, tmp: str, device, kinds: list) -> dict:
    """The control's and the planted faults' numbers on ``seed``: the
    reference (float64) put in the program's place, in bfloat16
    ("control"), with
    half of each batch left out ("half_batch") or, at the boundary,
    without density control's merge ("skip_merge"), against the
    reference. The first stage's checked steps start from the seed; the
    boundary (a configuration of more than one stage) from the program's
    own first stage run from the seed, as a run's check does."""
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
        if kind not in ("control", "half_batch", "skip_merge"):
            raise ValueError(f"no reading {kind!r} for a training cell")
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

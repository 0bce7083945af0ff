"""The port's training-step benchmark (port of the repository's bench.py):
rays/s through the whole training step on one card.

Prints ONE JSON line on stdout: {"metric": "train_step_rays_per_s_per_chip",
"value", "unit": "rays/s", "vs_baseline"}. Everything else goes to stderr.

The step (``make_scan_step``, bench.py:53-108): sample a batch of pixel
indices (uniform ratio 0.6), gather its rays, forward, the 5-term loss at
progress 0.5, backward, Adam with folded decay at a fixed learning rate of
0.01 for every parameter group; soft-min sharpness 18.5. The workload
(bench.py:141-162): 100 live primitives in a 128-slot table (centers
N(0, 0.3), raw radii N(-2, 0.3), seed 0), one 256² camera tiled 10 times
(655,360 rays), targets clip(|rd|, 0, 1), 30,000 foreground pixels, batch
16,384. ``SCAN_STEPS`` steps run per call through train/chunk.ChunkRunner:
on the card each replay of a captured CUDA graph runs ``--unroll`` steps
(the counterpart of bench.py's ``lax.scan`` with ``unroll``), so the
figure is the card's throughput, not the host's launch rate. The first
call is the warm-up (the capture); then the best of 3 calls, each from the
same parameters, a fresh Adam state and the same t cache, the sampler
seeded with the call's index.

Three steps are timed:

  * plain  — the plain PyTorch march and shade tail (ops/march.py,
             render/diff.py);
  * kernel — K1 (csrc/march_shade.cu) marches 40 steps cold, the plain
             tail shades (bench.py's ``pallas``, whose early exit is off by
             default);
  * warm   — K1 marches ``warm_steps`` (16) from ``warm_backoff`` × the
             per-pixel cached t and writes t back into the cache; K2
             (csrc/shade.cu) shades, forward and backward. The cache is
             filled by a cold K1 march over every pixel first.

``vs_baseline`` is the best step's rays/s over the plain step's. The line
is printed as soon as the three steps are timed; then the large-scene
flagship (``large_flagship``: the culled step at M = 51,200 through
tools/bench_large.py) and the guards run. On the CPU (``--device cpu``)
only the plain step runs, at batch 2,048, as bench.py does off its
accelerator.

Guards: the step's best rays/s and the flagship's against BENCH_TORCH.json,
a record of this port written only by ``--write-baseline`` (both entries)
or ``--write-large-baseline`` (the flagship's alone), on a card whose
nvidia-smi name and power limit equal the record's. Below 90% of the record
the command exits 2 after its JSON line; with no record, or a record from
another card, it says why it skips the guard and exits 0.

Usage (the card):
  python -m burn_raymarching_tpu_torch.tools.bench [--unroll 4]
      [--out FILE] [--write-baseline | --write-large-baseline]
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.tools.bench_large import (
    card,
    chunk_runner,
    profile_chunk,
    time_chunk,
)

SCAN_STEPS = 200
REPS = 3
SMOOTH_K = 18.5
PROGRESS = 0.5
UNIFORM_RATIO = 0.6
LR = 0.01
# Replays of the captured chunk that the profiler reads per variant.
PROFILE_CALLS = 5
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECORD = os.path.join(ROOT, "BENCH_TORCH.json")
TOLERANCE = 0.90


def make_scan_step(cfg, march_normal_fn, warm: bool = False):
    """The bench's step as a ChunkRunner step closure:
    step(params, generator, stage, step, mask, packed, fg_indices, n_fg,
    idx=None, t_cache=None, clusters=None, rep_static=None) → (loss, lr).
    It leaves the gradients in ``params``' ``.grad``; ``stage``, ``step``,
    ``clusters`` and ``rep_static`` are not read (the bench's schedule is
    fixed). ``march_normal_fn`` None is the plain march; with ``warm`` it
    marches from the t cache and K2 shades."""
    from burn_raymarching_tpu_torch.data.dataset import (
        gather_batch,
        sample_batch_indices,
    )
    from burn_raymarching_tpu_torch.models.scene import activate, scene_forward
    from burn_raymarching_tpu_torch.ops.cuda.shade_kernel import shade_fused
    from burn_raymarching_tpu_torch.train.loss import compute_loss

    def scan_step(params, generator, stage, step, mask, packed, fg_indices,
                  n_fg, idx=None, t_cache=None, clusters=None,
                  rep_static=None):
        if idx is None:
            idx = sample_batch_indices(generator, packed.shape[0],
                                       fg_indices, n_fg, cfg.batch_size,
                                       UNIFORM_RATIO)
        ro, rd, tgt = gather_batch(packed, idx)
        if warm:
            with torch.no_grad():
                c_det, _, r_det, _, _ = activate(params)
                t0 = t_cache[idx][:, None] * cfg.warm_backoff
                t, normal = march_normal_fn(
                    ro, rd, c_det, r_det, SMOOTH_K, mask=mask,
                    num_steps=cfg.warm_steps, t_init=t0)
                t_cache[idx] = t[:, 0]
            c, col, r, ld, amb = activate(params)
            out = shade_fused(ro, rd, t, normal, c, r, col, ld, amb,
                              SMOOTH_K, mask=mask)
        else:
            out = scene_forward(params, ro, rd, SMOOTH_K, mask=mask,
                                march_normal_fn=march_normal_fn)
        loss = compute_loss(params, out, tgt, PROGRESS, mask=mask,
                            cfg=cfg.loss)
        params.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach(), LR

    return scan_step


def make_workload(device, size: int = 256, views: int = 10,
                  n_prims: int = 100, slots: int = 128, n_fg: int = 30000):
    """bench.py's inputs → (padded params, mask, dataset dict with
    ``packed`` [P, 9], ``fg_idx`` (every pixel) and ``n_fg``)."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.models.scene import (
        init_scene_params,
        pad_params,
    )

    rng = np.random.default_rng(0)
    params = init_scene_params(n_prims, device=device)
    with torch.no_grad():
        params.centers.copy_(torch.as_tensor(
            rng.normal(0, 0.3, (n_prims, 3)), dtype=torch.float32))
        params.radii.copy_(torch.as_tensor(
            rng.normal(-2.0, 0.3, (n_prims, 1)), dtype=torch.float32))
    padded, mask = pad_params(params, slots)
    ro, rd = create_camera_rays(size, size, [0.0, 0.5, -2.5], [0, 0, 0],
                                50.0, device=device)
    ro, rd = ro.repeat(views, 1), rd.repeat(views, 1)
    packed = torch.cat([ro, rd, torch.clamp(rd.abs(), 0, 1)], dim=1)
    ds = {"packed": packed,
          "fg_idx": torch.arange(packed.shape[0], dtype=torch.int32,
                                 device=device),
          "n_fg": n_fg}
    return padded, mask, ds


@torch.no_grad()
def warm_t_cache(packed, padded, mask, batch: int) -> torch.Tensor:
    """The warm variant's t cache: a cold K1 march over every pixel in
    ``batch``-ray chunks (bench.py:172-181)."""
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade,
    )

    radii = torch.nn.functional.softplus(padded.radii) + 0.01
    out = []
    for s in range(0, packed.shape[0], batch):
        t, _ = march_shade(packed[s:s + batch, 0:3].contiguous(),
                           packed[s:s + batch, 3:6].contiguous(),
                           padded.centers, radii, SMOOTH_K, mask=mask)
        out.append(t[:, 0])
    return torch.cat(out)


def make_runner(cfg, step_fn, padded, mask, ds, t_cache=None,
                graphs: bool = False, idx_fn=None):
    """A ChunkRunner of the bench step on a fresh copy of ``padded`` (and
    of ``t_cache``), every group at scale 1, stage 0, generator seeded 0
    (tools/bench_large.chunk_runner)."""
    from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS

    return chunk_runner(cfg, step_fn, copy.deepcopy(padded),
                        {k: 1.0 for k in PARAM_KEYS}, 0, mask, ds["packed"],
                        ds["fg_idx"], ds["n_fg"], t_cache=t_cache,
                        graphs=graphs, idx_fn=idx_fn)


def bench(runner, batch: int, reps: int = 3, steps: int = SCAN_STEPS
          ) -> dict:
    """bench.py:111-128: one warm-up call, then the best of ``reps`` calls
    of ``steps`` chained steps, each from the runner's starting state with
    the sampler seeded with its index (tools/bench_large.time_chunk) →
    {rays_per_s, wall_ms_per_step, steps_run, ...}. Raises on a non-finite
    loss or parameter."""
    return time_chunk(runner, batch, reps, steps, rep_seed=0)


def run_variant(cfg, name: str, padded, mask, ds, reps: int, steps: int,
                graphs: bool) -> dict:
    """One variant: its launches (every counter set to 0 before it, read
    after it), rays/s and, on the card, the device profile."""
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade,
    )

    for fn in build.COUNTED:
        fn.launches = 0
    t_cache = None
    prefill_s = 0.0
    if name == "warm":
        t0 = time.perf_counter()
        t_cache = warm_t_cache(ds["packed"], padded, mask, cfg.batch_size)
        if graphs:
            torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    step_fn = make_scan_step(cfg, None if name == "plain" else march_shade,
                             warm=name == "warm")
    runner = make_runner(cfg, step_fn, padded, mask, ds, t_cache, graphs)
    try:
        out = {"variant": name, **bench(runner, cfg.batch_size, reps, steps),
               "prefill_s": prefill_s}
        if graphs:
            prof = profile_chunk(runner, PROFILE_CALLS)
            out.update(prof, device_busy_share=prof["device_busy_ms_per_step"]
                       / out["wall_ms_per_step"],
                       steps_run=out["steps_run"]
                       + PROFILE_CALLS * runner.unroll)
    finally:
        runner.close()
    out["launches"] = {fn.__name__: fn.launches for fn in build.COUNTED}
    return out


def replay_matches_steps(variant: str, device, batch: int = 16384,
                         size: int = 256, views: int = 10, steps: int = 8,
                         unroll: int = 4, seed: int = 7) -> dict:
    """The bench step (``kernel`` or ``warm``) for ``steps`` steps replayed
    from captured graphs of ``unroll`` steps beside the same steps one at
    a time, from the same start and sampler seed; then both reset to the
    start (``ChunkRunner.restore``, as ``bench`` resets each call) and run
    again with ``seed`` → {"first": gap, "reset": gap}, each the largest
    absolute difference of the parameters, the t cache and the last loss
    (inf when the samplers' states differ)."""
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade,
    )

    cfg = TrainConfig(batch_size=batch, scan_unroll=unroll)
    padded, mask, ds = make_workload(device, size, views)
    warm = variant == "warm"
    t_cache = warm_t_cache(ds["packed"], padded, mask, batch) if warm else None
    step_fn = make_scan_step(cfg, march_shade, warm=warm)
    runners = [make_runner(cfg, step_fn, padded, mask, ds, t_cache, graphs)
               for graphs in (True, False)]
    starts = [r.snapshot() for r in runners]
    gaps = {}
    try:
        for label, s in (("first", 0), ("reset", seed)):
            for runner, start in zip(runners, starts):
                runner.restore(start)
                runner.generator.manual_seed(s)
                runner.run(1, steps)
            a, b = runners
            if not torch.equal(a.generator.get_state(),
                               b.generator.get_state()):
                gaps[label] = math.inf
                continue
            pairs = list(zip(a.params.parameters(), b.params.parameters()))
            pairs.append((a.loss, b.loss))
            if warm:
                pairs.append((a.t_cache, b.t_cache))
            with torch.no_grad():
                gaps[label] = max(float((x - y).abs().max())
                                  for x, y in pairs)
    finally:
        for runner in runners:
            runner.close()
    return gaps


def flagship_config(steps: int = 50, **overrides):
    """bench.py:239-245: monopole far field, batch 16,384, culling at
    budget 256 on 512-ray tiles with hierarchical selection (group 64,
    cluster budget 32), cluster repulsion (K4), decoupled decay, warm start
    16 steps, ``steps`` steps per call. ``overrides`` replace fields (the
    CPU tests' tiny sizes)."""
    from burn_raymarching_tpu_torch.config import LossConfig, TrainConfig

    kw = dict(loss=LossConfig(repulsion_far_field="monopole"),
              batch_size=16384, use_culling=True, cull_budget=256,
              cull_tile=512, cull_hierarchical=True, cull_cluster_group=64,
              cull_cluster_budget=32, cluster_repulsion=True,
              weight_decay_mode="decoupled", warm_start=True, warm_steps=16,
              steps_per_call=steps, checkpoint_dir=None)
    kw.update(overrides)
    return TrainConfig(**kw)


def large_flagship(steps: int = 50, reps: int = 2, device="cuda",
                   m: int = 51200, pixels: int = 10 * 256 * 256,
                   side: int = 256, **overrides):
    """(ms/step, rays/s, record) of the flagship large-scene step
    (bench.py:224-250): the warm culled step at M = 51,200 on 10 × 256²
    pixels through tools/bench_large.bench_case, ``steps`` chained steps a
    call, best of ``reps``. The record also holds the same step one step
    at a time and, on the card, its device profile."""
    from burn_raymarching_tpu_torch.tools import bench_large as bl
    from burn_raymarching_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = flagship_config(steps, **overrides)
    ds = bl.make_dataset(pixels, side, dev)
    padded, mask = bl.make_params(m, dev)
    rec = bl.bench_case(cfg, ds, padded, mask, "warm", steps, reps)
    return rec["wall_ms_per_step"], rec["rays_per_s"], rec


def load_record(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def check_regression(value: float, where: str, path: str = RECORD,
                     key: str = "step", tolerance: float = TOLERANCE
                     ) -> int:
    """0 when ``value`` (rays/s) is at least ``tolerance`` × the record's
    ``key`` entry, or when the guard does not apply (no such record, or
    one from another card than ``where``); 2 below it. Says which on
    stderr."""
    prev = load_record(path).get(key)
    name = os.path.basename(path)
    if prev is None:
        print(f"{key} guard skipped: no {key!r} record in {name}",
              file=sys.stderr)
        return 0
    if prev["card"] != where:
        print(f"{key} guard skipped: {name} was recorded on "
              f"{prev['card']!r}, this card is {where!r}", file=sys.stderr)
        return 0
    if value < tolerance * prev["rays_per_s"]:
        print(f"BENCH REGRESSION ({key}): {value:,.0f} rays/s < "
              f"{tolerance:.0%} of recorded {prev['rays_per_s']:,.0f} "
              f"({name})", file=sys.stderr)
        return 2
    print(f"{key} guard ok: {value:,.0f} rays/s vs recorded "
          f"{prev['rays_per_s']:,.0f} ({name})", file=sys.stderr)
    return 0


def _commit() -> str:
    """git's HEAD of this checkout ("-dirty" with local changes), or
    "unknown" where the repository is not a git checkout of its own (a
    ``git archive`` copy)."""
    def git(*args) -> str:
        return subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=30,
                              check=True).stdout.strip()

    try:
        if os.path.realpath(git("rev-parse", "--show-toplevel")) != \
                os.path.realpath(ROOT):
            return "unknown"
        head = git("rev-parse", "--short", "HEAD")
        dirty = git("status", "--porcelain")
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return head + ("-dirty" if dirty else "")


def write_record(path: str, entries: dict, where: str, commit: str) -> None:
    """Merge ``entries`` ({"step": ..., "large": ...}) into the record,
    each stamped with the card, torch's version and the commit."""
    rec = load_record(path)
    for key, entry in entries.items():
        rec[key] = {**entry, "card": where, "torch": torch.__version__,
                    "commit": commit}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(f"wrote {sorted(entries)} to {path}", file=sys.stderr)


def large_entry(ms: float, rays: float, rec: dict) -> dict:
    return {"m": rec["m"], "cull_budget": rec["budget"],
            "hier": rec["hier"], "warm_steps": rec["warm_steps"],
            "rep_far_field": rec["far_field"], "ms_per_step": ms,
            "rays_per_s": rays,
            "ms_per_step_one_at_a_time":
                rec["wall_ms_per_step_one_at_a_time"]}


def _say(what: str, rec: dict) -> None:
    line = (f"{what:>7}: {rec['rays_per_s'] / 1e6:8.3f} Mrays/s  "
            f"{rec['wall_ms_per_step']:8.4f} ms/step wall")
    if "device_busy_ms_per_step" in rec:
        line += (f"  {rec['device_busy_ms_per_step']:8.4f} ms busy  "
                 f"{rec['host_launches_per_step']:.2f} host launch calls"
                 f"/step  hand kernels ms/step "
                 f"{json.dumps(rec['hand_kernels_ms_per_step'])}")
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unroll", type=int, default=4,
                    help="steps per captured CUDA graph (bench.py's "
                         "BENCH_UNROLL)")
    ap.add_argument("--out", default=None,
                    help="write every figure of the run here (JSON)")
    ap.add_argument("--write-baseline", dest="write_baseline",
                    action="store_true",
                    help="record the step and the flagship in "
                         "BENCH_TORCH.json")
    ap.add_argument("--write-large-baseline", dest="write_large",
                    action="store_true",
                    help="record the flagship alone")
    args = ap.parse_args(argv)

    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if (args.write_baseline or args.write_large) and not on_card:
        raise SystemExit("bench: a CPU run writes no record of the card")
    where = card() if on_card else "cpu"
    commit = _commit()
    print(f"bench: {where}; torch {torch.__version__}", file=sys.stderr)

    if args.write_large:
        ms, rays, rec = large_flagship(device=dev)
        _say("large", rec)
        entry = large_entry(ms, rays, rec)
        write_record(RECORD, {"large": entry}, where, commit)
        print(json.dumps(entry), flush=True)
        return 0

    batch = 16384 if on_card else 2048
    cfg = TrainConfig(batch_size=batch, scan_unroll=args.unroll)
    padded, mask, ds = make_workload(dev)
    result = {"card": where, "torch": torch.__version__, "commit": commit,
              "batch": batch, "pixels": int(ds["packed"].shape[0]),
              "variants": {}}
    for name in ("plain", "kernel", "warm") if on_card else ("plain",):
        rec = run_variant(cfg, name, padded, mask, ds, REPS, SCAN_STEPS,
                          graphs=on_card)
        result["variants"][name] = rec
        _say(name, rec)
    rays = {k: v["rays_per_s"] for k, v in result["variants"].items()}
    best_name = max(rays, key=rays.get)
    best = rays[best_name]
    line = {"metric": "train_step_rays_per_s_per_chip",
            "value": round(best, 1), "unit": "rays/s",
            "vs_baseline": round(best / rays["plain"], 3)}
    result["line"] = line
    # The line first, as bench.py prints it: a flagship that raises (a
    # non-finite loss, out of memory) then loses only its own figures.
    print(json.dumps(line), flush=True)
    code = 0
    if on_card:
        for fn in build.COUNTED:
            fn.launches = 0
        ms, large_rays, rec = large_flagship(device=dev)
        rec["launches"] = {fn.__name__: fn.launches for fn in build.COUNTED}
        result["large"] = rec
        _say("large", rec)
        print(f"  large: {rec['wall_ms_per_step_one_at_a_time']:.3f} ms/step "
              f"one step at a time", file=sys.stderr)
        if args.write_baseline:
            step = result["variants"][best_name]
            write_record(RECORD, {
                "step": {"variant": best_name, "rays_per_s": best,
                         "ms_per_step": step["wall_ms_per_step"],
                         "unroll": args.unroll},
                "large": large_entry(ms, large_rays, rec)}, where, commit)
        code = max(check_regression(best, where, RECORD, "step"),
                   check_regression(large_rays, where, RECORD, "large"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return code


if __name__ == "__main__":
    sys.exit(main())

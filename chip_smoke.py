#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Runs the port (burn_raymarching_tpu_torch) end to end on the card, in
phases, each printing one JSON line; any failure raises and the script exits
non-zero without the final result line:

  1. device      — torch's device name and nvidia-smi's name and power limit;
  2. build       — nvcc-builds every kernel library from csrc/, one nvcc per
                   source, all started together;
  3. kernels     — the launch of an empty kernel, timed like the kernels (the
                   floor under any launch); K1 and K2 against their plain
                   PyTorch versions at the config-1 path's shapes (16,384
                   rays of the 10-view 256² dango rig, 100 live primitives in
                   a 128-slot table): max abs error against the stated
                   tolerance, median CUDA-event times of both and the
                   kernel's device time (CUDA-graph replay); K1 also at the
                   narrower tables config 1 trains at (7 live in 8 slots, 25
                   in 32), with its and the plain version's gap to a float64
                   march; K2 also at 10 live in 16 slots (what the step runs
                   after a short training), its gradients against autograd
                   of the plain tail, bitwise repeats, exactly zero gradients
                   in padded slots, and the sum over its per-block partial
                   rows, which the backward launch holds inside, against
                   ``sum(0)`` of the same rows; the kernels that pack K1's
                   and K2's tables, bitwise against their plain versions;
  4. kernels_c4  — K3 against its plain version at config-4 shapes (32 tiles
                   x 512 rays of the 30-view 512² knot rig, K = 2,048,
                   k = 128, tables from a real selection over 5,120
                   knot-seeded primitives), cold (40 steps) and warm (16
                   steps from 0.8 t_cold), within 5x the plain version's
                   own float32 error against float64; its chunked path (8
                   tiles against 8,192 live columns, more than the resident
                   table holds) the same way; K6 (the culled step's
                   fused tail) forward and gradients on the same tiles
                   (and on 4 tiles of 2,048 valid slots, staged in two
                   chunks) against the plain tail, within 5x its own
                   float32 error against float64, bitwise repeats, its
                   launches and the plain tail timed; K4 forward and
                   backward against autograd of the plain versions, member
                   and monopole, at C = 80 (config 4) and C = 800
                   (M = 51,200), with a bitwise repeat check of its
                   results and its sums over blocks against one PyTorch
                   ``sum`` of the same parts; K7 (flat per-tile selection)
                   on the same 32 ray tiles at config 4's step table
                   (8,192 slots, K = 2,048), a later stage's prefill table
                   (2,048 slots, K = 2,048) and the bench flagship's
                   prefill (51,200 rows, K = 256): its cones against
                   tile_cones, its tables against the plain selection on
                   its own cones (k7_compare), its gathers bitwise, a
                   repeat and a graph replay bitwise, timed beside the
                   plain selection;
  5. generate    — the port's generator writes the dango dataset (10 views at
                   256²) into a temporary directory;
  6. train       — train_cli at config-1 width (batch 16,384, reference init,
                   default flags, kernels on) for 2 stages x 100 steps, which
                   crosses one density-control boundary and exports
                   scene.json; K1 and K2's launch counters must have grown
                   during it; then the final loss, train-view PSNR and
                   steady-state rays/s of the kernel step (replayed from a
                   CUDA graph, as run_stage runs it, and one step at a
                   time) and of the --no-pallas step, and the kernel
                   step's device-busy time and each hand-written kernel's
                   share of it (torch.profiler); then chunk_c1: one
                   100-step chunk replayed from a captured graph beside
                   the same chunk run one step at a time, twice, from one
                   state and generator (phase_chunk: the indices of every
                   step bitwise equal, the parameters within 2x the two
                   plain runs' gap, wall and device-busy ms, busy share
                   and the host's launch calls per step of both, each hand
                   kernel's trace events equal to its launch count);
  7. generate_c4 — the generator writes the config-4 knot set (30 views at
                   512², 400 GT spheres, GT k 128, sharpness 40);
  8. train_c4    — tools/run_c5.py with config 4's flags cut to 2 stages x
                   100 steps, which still crosses one density boundary with
                   the merge; K3 and K4's launch counters must have grown
                   (its init and trained PSNR passes included); the loss
                   must be finite and the culled train-view PSNR above the
                   init's; then, on a Trainer of the same configuration
                   holding the scene the run exported, steady-state rays/s
                   of the kernel and --no-pallas steps and the kernel step's
                   device-busy share (torch.profiler), captured and one
                   step at a time; then chunk_c4 (phase_chunk on that
                   trainer); then a 2 x 30-step run with --split-mode
                   residual across one boundary: N before and after and
                   the number split;
  9. refine_c4   — the quality recipe on the same knot set through
                   tools/run_c5.py: runs/c4_headline/scene_c5.json (the JAX
                   package's 28.39 dB scene) loaded with --from-scene under
                   its recipe (gaussian coverage, mask sharpness 40), its
                   PSNR held to the recorded one within 0.1 dB, then one
                   polish round of 100 steps and one refine round (512-tile
                   acceptance batches, residual proposal bias, colour and
                   light proposals), neither returning a lower PSNR; K3 and
                   K4 must have been launched; then one refine round at fine
                   proposal scales on the scene phase 8 trained, which must
                   accept proposals, and whose gate must agree with the
                   scene it exports; K3 at the acceptance loss's shape (512
                   tiles x 512 rays, K = 2,048, cold) against its plain
                   version on a slice of those tiles; per proposal wall ms,
                   device-busy share, K3 ms and peak memory; the residual
                   scores of two calls bitwise equal;
 10. guard_c1    — train_cli at config-1 width for 2 x 100 steps with
                   --stage-guard, --ss-stages 4,1 and --polish 1: the
                   guard's PSNRs and retry counts; K1 and K2 must have been
                   launched;
 11. c5          — config 5 through tools/run_c5.py: the generator writes
                   the 100-view 256² knot set (2,000 GT spheres); the
                   recipe (51,200 prior-seeded spheres, budget 4,096, tile
                   sampling, warm start, cluster repulsion at C = 800)
                   trains 2 x 50 steps on its first 20 views, with its
                   ceiling, init and trained PSNR (K1, K3 and K4 must have
                   been launched); the step's wall and device-busy time,
                   host launches and top device ops on the scene it
                   trained, captured and one step at a time; K3 at config 5's
                   shape (32 tiles x 512 rays, K = 4,096) against its plain
                   version; runs/c5_stack3/scene_c5.json through
                   --from-scene on all 100 views, within 0.1 dB of the
                   28.51 dB its record holds;
 12. distributed — DistributedTrainer on a 1 x 1 mesh over NCCL, whose
                   steps replay captured CUDA graphs (its "graphs" event
                   must say so): a one-stage cut of config 4, bitwise
                   against the same trainer forced to one step at a time
                   (a subclass's _replays_graphs) and against the plain
                   Trainer started from the init that this script sorts in
                   Morton order (the sharded trainer's row order), and
                   against the plain Trainer in its own row order at the
                   JAX package's tolerance (K3 must have been launched);
                   and 60 dense config-1 steps with --turbo (K1 and K2)
                   bitwise against its own eager run and the Trainer
                   without warm start; peak memory of each captured run;
                   then phase_chunk on each sharded trainer's step
                   (chunk_dist_c4, chunk_dist_c1: wall, busy and host
                   launch calls per step, captured and one step at a
                   time; at most 3 calls a captured step) and on the plain
                   Trainer's step from the same state (its K4 and frozen
                   repulsion prep; chunk_dist_*_plain_trainer); then two model
                   ranks on the one card over gloo (NCCL takes one GPU per
                   rank; gloo's host staging cannot be recorded, so they
                   run one step at a time and the line says so): each
                   selects per-tile top-1,024 tables over its half of the
                   rows and marches through the union-table wrapper, one
                   K3 launch on [B/2, 2,048] tables; held against one K3
                   launch on the same union table (rtol 2e-5, normals
                   1e-3, the JAX package's sharding tests) and K3 at that
                   shape against its plain version; with two or more cards,
                   two NCCL ranks (one per card) train the tiny config-4
                   cut of tests/torch_dist.py at 1 x 2 and 2 x 1, captured
                   against one step at a time, bitwise; with one card the
                   line distributed_nccl_2card says it did not run;
 13. viewer      — the offline and HTTP viewers on
                   runs/c5_headline/scene_c5.json (2,435 spheres) from the
                   default orbit pose: 512² train-model frames through
                   render_pose with K1 counted (ceil(512²/16,384) launches
                   a frame), held to the same frame through the plain march
                   within the viewer's uint8 bounds, with frame ms,
                   device-busy and K1 ms per frame against K1's bound, and
                   K1 on one 16,384-ray chunk against its plain version;
                   the viewer model's float32 frame against float64 at
                   128²; frame ms of both models at 96², 384² and 512²;
                   the HTTP viewer (page, /scene, low and full frames of
                   both models, decoded with read_png); one frame under
                   utils.profiling.trace, whose trace must hold the
                   annotation and K1;
 14. bench       — tools/bench.main at full width (the port's bench.py:
                   16,384 rays, 100 live of 128 slots, 200 chained steps a
                   call through captured graphs of 4 steps, best of 3; the
                   plain, kernel (K1 cold) and warm (K1 warm + K2)
                   variants, then the flagship: the warm culled step at
                   M = 51,200 through tools/bench_large.py, K3 and K4): its
                   one stdout JSON line (vs_baseline > 1) and each
                   variant's figures on phase lines; each variant's
                   launches (every count set to 0 before it, read after
                   it) held to once per step it ran (none on the plain
                   step; K1 and its pack also once per prefill chunk); the
                   flagship's K3, K4 fwd and bwd launched, its steps
                   replaying graphs with at most 3 host launch calls a
                   step; the captured warm bench step held bitwise to the
                   same 8 steps one at a time, from the same start and
                   seed and again after the bench's reset to the start;
 15. dryrun      — tools/dryrun_multichip (the port of __graft_entry__.py):
                   the entry forward (16,384 rays against 128 slots),
                   finite and held to its float64 twin; the dry run's five
                   parts on one NCCL rank in this process (every part's
                   steps replaying captured graphs, K3 launched on part
                   (d)), on two gloo ranks sharing the card (1 x 2: K3 on
                   the union table, one step at a time) and, with two or
                   more cards, on min(cards, 4) NCCL ranks, one per card;
 16. defaults    — the library flow with no device named: on phase 5's
                   dango set at config-1 width (TrainConfig's defaults,
                   kernels on), build_dataset(cfg) must land on the card
                   and Trainer(cfg, dataset).run() train 2 stages x 20
                   steps across one density boundary through K1 and K2
                   (every count set to 0 before the run and read after it)
                   to a finite loss; raw_from_physical on phase 6's
                   scene.json, params_from_numpy, init_scene_params,
                   init_scene_params_cloud, create_camera_rays and
                   build_clusters, each called without a device, must
                   return tensors on the card;
 17. variants    — K5 (csrc/march_variants.cu, the port of
                   scripts/exp_march_variants.py::variant_march, on K1's
                   march core) first against K1 on one table (K1's pack of
                   the tool's scene, 40 steps): its base must give K1's t
                   and normals bitwise, and both are timed in turn (device
                   ms, their ratio); then against its
                   plain version in all eight clamp / exp2 / coord
                   combinations at the variant tool's shape (16,384 rays,
                   100 live of 128 slots, 40 steps, 128 rays a block):
                   hit rays and all rays within 5x the plain version's own
                   gap to float64 (as K3), for clamp also the rays its 1e-8
                   floor stalls; bitwise equal at 64 and 1,024 rays a
                   block; then the two march tools' main at full size
                   (tools/exp_march_variants.py: its three tables over the
                   eight variants and seven block sizes; tools/roofline.py:
                   the empty-kernel floor, the unfused exp+sqrt stream and
                   K1 at 40 and 16 steps, 200 chained iterations), one
                   timing repeat each, with K5 and K1 counted.
K1's early exit (``early_exit=True``; no path sets it) is held at every
table width of phase 3 against the fixed-count launch, against its plain
version, and timed beside the fixed-count launch.
The line before the last is {"kernels": [...]}: per kernel its launches on
the training path (``launches``; a kernel that a CUDA-graph replay launches
counts once per replay, train/chunk.py), on the quality path that runs it
(``launches_quality``: phase 9 for K3, K4 and K7, phase 10 for K1 and K2), on
the config-5 path (``launches_c5``), on the distributed paths
(``launches_distributed``), on the viewer's (``launches_viewer``), on
the bench's (``launches_bench``: its three variants and the flagship) and
on the dry run's (``launches_dryrun``: phase 15's runs, all ranks), on
the library defaults' (``launches_defaults``: phase 16's training run),
on the march tools' (``launches_variants``: phase 17's tool runs; K5 runs
on no other path, and reads 0 on the others),
error, ``ms`` (the wrapper call between CUDA events),
``device_ms`` (the same call replayed from a CUDA graph), the plain
version's time, ``bound_ms`` (the least time the card could take, see
``bound``) and ``library_ms`` (one PyTorch call computing the same function,
where there is one). A sum over blocks that a launch holds inside is
reported with it: ``sum_device_ms`` (the launch with the sum less the launch
without), ``sum_library_ms`` and ``sum_library_device_ms`` (``sum`` over the
same parts). The last line is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (from the repository root; needs one GPU)
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_STAGES = 2
TRAIN_STEPS = 100
N_RAYS = 16384
M_LIVE, M_SLOTS = 100, 128
# The narrower tables config 1 trains at (live primitives, slots).
K1_NARROW = ((7, 8), (25, 32))
# K2's second shape: what the config-1 step trace runs after 2 x 100 steps.
K2_NARROW = (10, 16)
# Train-view PSNR floor after the short 2 x 100-step run: far below a full
# run's ~30 dB, far above the ~10 dB of an untrained or broken scene.
MIN_PSNR_DB = 15.0
LIBRARIES = ("march_shade", "shade", "culled_march", "culled_shade",
             "repulsion", "tile_select", "march_variants", "noop")
# Config 4 (runs/c4_r2): the knot capture, the prior-seeded init and the
# per-tile top-K budget.
C4_VIEWS, C4_SIZE, C4_GT_N, C4_INIT_N = 30, 512, 400, 5120
C4_TILES, C4_TILE, C4_BUDGET, C4_K = 32, 512, 2048, 128.0
# M = 51,200: scripts/bench_large.py's primitive count (C = 800 clusters).
LARGE_INIT_N = 51200
# K3's chunked path: tiles x live columns (the resident table holds 4,096).
CHUNKED_TILES, CHUNKED_K = 8, 8192
# The card's peak rates for ``bound``: device memory (data sheet, H100 SXM),
# FP32 outside the tensor cores, and SFU lanes per clock per SM (sqrt, exp,
# reciprocal), which phase_device scales by the SM count and the maximum SM
# clock that nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_LANES_PER_CLK_PER_SM = 16
CARD = {}
# The JAX package's headline config-4 scene and the PSNR it recorded for it
# (runs/c4_headline/results.json "trained"); the port's evaluator must read
# the same scene within HEADLINE_TOL_DB on the port's own knot set.
HEADLINE_SCENE = os.path.join(ROOT, "runs", "c4_headline", "scene_c5.json")
HEADLINE_PSNR_DB = 28.39054227314559
HEADLINE_TOL_DB = 0.1
# The acceptance loss's shape: tiles per batch, and the slice of them that
# K3 is held against its plain version on.
REFINE_TILES, REFINE_CHECK_TILES = 512, 16
# Config 5 (runs/c5_r2; tools/run_c5.py's defaults): 100 views at 256²,
# 2,000 GT spheres, 51,200 prior-seeded spheres, per-tile budget 4,096.
# The smoke run trains on the first C5_TRAIN_VIEWS views for 2 x C5_STEPS
# steps; the committed scene below is read on all 100 views and must land
# within HEADLINE_TOL_DB of the PSNR its record holds
# (runs/c5_stack3/results.json "trained").
C5_VIEWS, C5_SIZE, C5_GT_N, C5_INIT_N, C5_BUDGET = 100, 256, 2000, 51200, 4096
C5_TRAIN_VIEWS, C5_STEPS = 20, 50
C5_SCENE = os.path.join(ROOT, "runs", "c5_stack3", "scene_c5.json")
C5_SCENE_PSNR_DB = 28.5149576006399
# Steps of the 1 x 1 DistributedTrainer runs (one stage each).
DIST_STEPS = 60
# Phase 13, the viewers: the config-5 headline scene (2,435 spheres, past
# K1's 1,024-slot shared-memory chunk) from the viewer's default orbit pose,
# frames rendered VIEWER_CHUNK rays at a time (render_pose's default), the
# HTTP viewer's full size (its low size is a quarter of it), and the uint8
# bounds of the viewer's golden test (tests/test_viewer_shader.py): mean
# |du8| and the share of pixels more than 2 LSB off; and the bound the CPU
# viewer tests put on the share of pixels lit in one frame and black in the
# other (tests/test_torch_viewer.py), so lost or gained hits on a thin
# silhouette do not hide under the two means.
VIEWER_SCENE = os.path.join(ROOT, "runs", "c5_headline", "scene_c5.json")
VIEWER_EYE = [2.5, 0.5, 0.0]
VIEWER_SIZE, VIEWER_CHUNK, SERVER_SIZE = 512, 16384, 384
VIEWER_MEAN_LSB, VIEWER_OFF2_SHARE = 0.05, 0.002
VIEWER_LIT_MISMATCH = 0.005


def events_of(events: list, kind: str) -> list:
    """The records of one kind from a ``Trainer.events`` list."""
    return [e for e in events if e["kind"] == kind]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: the call is captured into a CUDA graph
    ``launches`` times and the graph replayed between CUDA events, so the
    host's launch work (which exceeds a 0.1 ms kernel's own time) does not
    enter. Median over ``reps`` replays. Warm-up and capture share one side
    stream, so that a ``fn`` that runs autograd finds its nodes there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2]


def check_close(failures: list, name: str, err: float, tol: float) -> None:
    """Record a comparison that is not finite or exceeds its tolerance; the
    phase raises once it has printed all of its numbers."""
    if not math.isfinite(err) or err > tol:
        failures.append(f"{name}: max abs err {err:.3e} > tol {tol:.1e}")


def bound(nbytes: float, sfu_ops: float = 0.0, flops: float = 0.0) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its operations over their peak rate: special-function
    operations (one sqrt, exp or reciprocal each) over the SFU rate, other
    floating-point operations over the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(sfu_ops / CARD["sfu_per_s"], flops / FP32_FLOP_PER_S)
    return {"bound_ms": 1000.0 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def march_bound(pairs: float, *tensors) -> dict:
    """K1 / K3 / K5: one sqrt and one exp per (point, live primitive) pair,
    with ~12 other FP32 operations around them."""
    return bound(tensor_bytes(*tensors), sfu_ops=2.0 * pairs,
                 flops=12.0 * pairs)


def march_errors(torch, t_k, n_k, t_p, n_p) -> dict:
    """K1 or K3 against its plain version. The march is ill-conditioned on some
    rays (on this input the plain march in float32 differs from float64 by
    up to 4e-3 in t on hit rays, 4e-4 relative on missed rays, and 1.3e-3
    in the normal), so t is held to |dt| <= 1e-2 on rays that hit (t < 10)
    and |dt|/(1+t) <= 2e-3 on all rays, normals to 5e-3 on hit rays."""
    t_k, t_p = t_k.reshape(-1, 1), t_p.reshape(-1, 1)
    n_k, n_p = n_k.reshape(-1, 3), n_p.reshape(-1, 3)
    hit = t_p[:, 0] < 10.0
    dt = (t_k - t_p).abs()[:, 0]
    dn = (n_k - n_p).abs().amax(dim=1)
    return {
        "hit_rays": int(hit.sum()),
        "max_abs_err_t_hit": dt[hit].max().item(),
        "p50_abs_err_t_hit": torch.quantile(dt[hit], 0.5).item(),
        "p99_abs_err_t_hit": torch.quantile(dt[hit], 0.99).item(),
        "max_rel_err_t_all": (dt / (1.0 + t_p[:, 0].abs())).max().item(),
        "max_abs_err_normal_hit": dn[hit].max().item(),
        "p50_abs_err_normal_hit": torch.quantile(dn[hit], 0.5).item(),
        "p99_abs_err_normal_hit": torch.quantile(dn[hit], 0.99).item(),
    }


def float64_gaps(torch, t_k, n_k, t_p, n_p, t_64, n_64) -> dict:
    """The kernel's and the plain float32 version's gaps to the same march
    in float64 (``march_errors`` of each: maximum, median and 99th
    percentile over hit rays), and the plain version's gap on the two rays
    where the kernel's is largest: a worst ray that is ill-conditioned is
    far off in every float32 rounding, the plain one included."""
    t_64, n_64 = t_64.float(), n_64.float()
    out = {"plain_vs_float64": march_errors(torch, t_p, n_p, t_64, n_64),
           "kernel_vs_float64": march_errors(torch, t_k, n_k, t_64, n_64)}
    hit = t_64.reshape(-1) < 10.0
    for key, a_k, a_p, a_64 in (("t", t_k, t_p, t_64), ("normal", n_k, n_p,
                                                        n_64)):
        width = a_64.reshape(hit.numel(), -1).shape[1]
        gap_k, gap_p = (((a - a_64).abs().reshape(-1, width).amax(dim=1)
                         * hit) for a in (a_k, a_p))
        worst = int(gap_k.argmax())
        out[f"kernels_worst_{key}_ray"] = {
            "kernel_gap": gap_k[worst].item(),
            "plain_gap": gap_p[worst].item(),
            "hit_rays_where_plain_gap_exceeds_it": int(
                (gap_p > gap_k[worst]).sum())}
    return out


MARCH_TOLS = {"max_abs_err_t_hit": 1e-2, "max_rel_err_t_all": 2e-3,
              "max_abs_err_normal_hit": 5e-3}


def march_noise_tols(torch, t_p, n_p, t_64, n_64) -> dict:
    """K3's tolerances, from the float32 noise of the march itself: 5x the
    plain version's own error against the same march in float64, plus
    1e-5. At k = 128 around spheres of radius ~0.03 the cancellation error
    of the expanded |p - c|^2 (~ulp(|p|^2)) becomes ~2e-6 in the distance,
    which the normal's 1/(2 eps) difference scales to ~1e-2 and the march
    carries into t on grazing rays. A kernel that rounds no worse than the
    plain version stays within about twice that noise of it; each figure
    is a maximum over a few thousand rays, decided by the few worst-
    conditioned ones, and two roundings of those differ by up to 2.6x more
    (warm t: 1.9e-4 against a float64 error of 5.2e-5, H100)."""
    noise = march_errors(torch, t_p, n_p, t_64.float(), n_64.float())
    return {key: 5.0 * noise[key] + 1e-5 for key in MARCH_TOLS}


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    max_sm_mhz, sm_mhz = (float(x) for x in clocks.strip().split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["sfu_per_s"] = SFU_LANES_PER_CLK_PER_SM * sms * max_sm_mhz * 1e6
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         sms=sms, clocks_max_sm_mhz=max_sm_mhz, clocks_sm_mhz=sm_mhz,
         sfu_ops_per_s=CARD["sfu_per_s"], hbm_bytes_per_s=HBM_BYTES_PER_S,
         fp32_flop_per_s=FP32_FLOP_PER_S)
    return name


def phase_build() -> None:
    from burn_raymarching_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all(LIBRARIES)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_library_s={k: round(v, 3) for k, v in build.BUILD_SECONDS.items()})
    for name, log in build.BUILD_LOG.items():
        print(f"# ptxas {name}: " + " | ".join(
            ln.strip() for ln in log.splitlines() if "Used" in ln
            or "spill" in ln), flush=True)


def main_path_inputs(torch, dev, live: int = M_LIVE, slots: int = M_SLOTS):
    """16,384 rays drawn from the dango rig's 10 views at 256², and a
    ``slots``-slot table with ``live`` random primitives (seeded)."""
    import numpy as np

    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.models.scene import (
        activate,
        init_scene_params,
        pad_params,
    )
    from burn_raymarching_tpu_torch.tools.generate import default_cameras

    rng = np.random.default_rng(0)
    ro_all, rd_all = [], []
    for cam in default_cameras():
        ro, rd = create_camera_rays(256, 256, cam["origin"], cam["target"],
                                    cam["fov"], device=dev)
        ro_all.append(ro)
        rd_all.append(rd)
    pick = torch.as_tensor(rng.choice(10 * 65536, N_RAYS, replace=False),
                           device=dev)
    ro = torch.cat(ro_all)[pick].contiguous()
    rd = torch.cat(rd_all)[pick].contiguous()
    params = init_scene_params(live, device=dev)
    with torch.no_grad():
        params.centers.copy_(torch.as_tensor(
            rng.normal(0, 0.3, (live, 3)), device=dev))
        params.radii.copy_(torch.as_tensor(
            rng.normal(-2.0, 0.3, (live, 1)), device=dev))
        params.colors.copy_(torch.as_tensor(
            rng.normal(0, 1.5, (live, 3)), device=dev))
        params.light_dir.copy_(torch.tensor([0.3, 1.0, -0.4], device=dev))
    padded, mask = pad_params(params, slots)
    cot = torch.as_tensor(rng.normal(0, 1, (N_RAYS, 3)), dtype=torch.float32,
                          device=dev)
    return ro, rd, padded, mask, activate, cot


def k1_early_exit(torch, k1, args, mask, t_fixed, n_fixed, tols, label,
                  failures) -> dict:
    """K1 with ``early_exit=True`` at one table width.

    Against the fixed-count launch (the same arithmetic up to the exit): a
    ray that the fixed march brings to a hit (t < 10) has converged, and
    the two may differ by ``early_exit_tolerance`` there (at most num_steps
    further steps, each under 1e-5); the normals by MARCH_TOLS'; a ray ends
    past MISS_T in one exactly when it does in the other. Against the plain
    early exit (every ray frozen on its own): the fixed march's tolerances
    plus the early exit's. The work counted for the bound is what this
    run's rays need: for each ray the steps until the plain early exit
    froze it, plus the 7 evaluations after the march."""
    ro, rd, c, r, k = args
    tol_exit = k1.early_exit_tolerance(40)
    t_e, n_e = k1.march_shade(*args, mask=mask, early_exit=True)
    t_p, n_p = k1.march_shade_plain(*args, mask=mask, early_exit=True)
    hit = t_fixed[:, 0] < 10.0
    dt = (t_e - t_fixed).abs()[:, 0]
    dn = (n_e - n_fixed).abs().amax(dim=1)
    past = (t_e[:, 0] >= k1.MISS_T) != (t_fixed[:, 0] >= k1.MISS_T)
    vs_plain = march_errors(torch, t_e, n_e, t_p, n_p)
    out = {"tol_t_vs_fixed": tol_exit,
           "max_abs_err_t_hit_vs_fixed": dt[hit].max().item(),
           "max_abs_err_normal_hit_vs_fixed": dn[hit].max().item(),
           "rays_past_miss_t_in_one_only": int(past.sum()),
           "vs_plain_early_exit": vs_plain}
    check_close(failures, f"K1 {label} early exit t vs fixed",
                out["max_abs_err_t_hit_vs_fixed"], tol_exit)
    check_close(failures, f"K1 {label} early exit normal vs fixed",
                out["max_abs_err_normal_hit_vs_fixed"],
                tols["max_abs_err_normal_hit"])
    check_close(failures, f"K1 {label} early exit rays past MISS_T",
                float(out["rays_past_miss_t_in_one_only"]), 0.0)
    check_close(failures, f"K1 {label} early exit t vs plain",
                vs_plain["max_abs_err_t_hit"],
                tols["max_abs_err_t_hit"] + tol_exit)
    check_close(failures, f"K1 {label} early exit normal vs plain",
                vs_plain["max_abs_err_normal_hit"],
                tols["max_abs_err_normal_hit"])
    # Steps each ray needs: those the plain freeze took.
    _, steps = k1.march_early_exit(*args, mask=mask, return_steps=True)
    n_live = int(mask.sum())
    out["mean_steps_needed"] = steps.mean().item()
    out["ms"] = time_ms(torch, lambda: k1.march_shade(
        *args, mask=mask, early_exit=True))
    out["device_ms"] = graph_ms(torch, lambda: k1.march_shade(
        *args, mask=mask, early_exit=True))
    out["plain_ms"] = time_ms(torch, lambda: k1.march_shade_plain(
        *args, mask=mask, early_exit=True), reps=5)
    out.update(march_bound(float((steps.sum() + 7.0 * steps.numel())
                                 * n_live), ro, rd, c, r, t_e, n_e))
    return out


def phase_kernels(torch, dev) -> dict:
    from burn_raymarching_tpu_torch.ops.cuda import build
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1

    # What any launch pays: an empty kernel, timed like the kernels.
    emit("launch_floor", what="one launch of an empty kernel",
         ms=time_ms(torch, lambda: build.launch_noop(dev)),
         device_ms=graph_ms(torch, lambda: build.launch_noop(dev)))
    ro, rd, padded, mask, activate, _ = main_path_inputs(torch, dev)
    k = 18.5
    results = {}
    with torch.no_grad():
        c, _, r, _, _ = activate(padded)

    # K1 cold (40 steps) and warm (16 steps from 0.8 t_cold), with the
    # kernel's and the plain version's gap to the same march in float64.
    failures = []

    def k1_case(ro, rd, c, r, mask, label, main: bool):
        """One table width → (errors, times and bound; the kernel's t and
        normals). The main shape keeps the fixed MARCH_TOLS, cold and warm;
        a narrow one is held cold to the larger of those and 5x the plain
        version's own gap to float64 (other rays are ill-conditioned)."""
        args = (ro, rd, c, r, k)
        t_k, n_k = k1.march_shade(*args, mask=mask)
        t_p, n_p = k1.march_shade_plain(*args, mask=mask)
        t_64, n_64 = k1.march_shade_plain(ro.double(), rd.double(),
                                          c.double(), r.double(), k,
                                          mask=mask)
        out = {"cold": march_errors(torch, t_k, n_k, t_p, n_p)}
        out["cold"].update(float64_gaps(torch, t_k, n_k, t_p, n_p, t_64,
                                        n_64))
        tols = dict(MARCH_TOLS)
        if main:
            kw = dict(mask=mask, num_steps=16,
                      t_init=(t_p * 0.8).contiguous())
            out["warm16"] = march_errors(
                torch, *k1.march_shade(*args, **kw),
                *k1.march_shade_plain(*args, **kw))
        else:
            noise = march_noise_tols(torch, t_p, n_p, t_64, n_64)
            tols = {key: max(tol, noise[key]) for key, tol in tols.items()}
        for phase, errs in out.items():
            for key, tol in tols.items():
                check_close(failures, f"K1 {label} {phase} {key}", errs[key],
                            tol)
        out["ms"] = time_ms(torch, lambda: k1.march_shade(*args, mask=mask))
        out["device_ms"] = graph_ms(
            torch, lambda: k1.march_shade(*args, mask=mask))
        out["plain_ms"] = time_ms(
            torch, lambda: k1.march_shade_plain(*args, mask=mask), reps=10)
        live = int(mask.sum())
        out.update(march_bound(ro.shape[0] * live * 47.0, ro, rd, c, r,
                               t_k, n_k))
        out["early_exit"] = k1_early_exit(torch, k1, args, mask, t_k, n_k,
                                          tols, label, failures)
        emit("kernel", name="march_shade", slots=c.shape[0], live=live,
             tol=tols, **out)
        return out, (t_k, n_k)

    for live, slots in K1_NARROW:
        _, _, narrow, narrow_mask, _, _ = main_path_inputs(torch, dev, live,
                                                           slots)
        with torch.no_grad():
            c_n, _, r_n, _, _ = activate(narrow)
        k1_case(ro, rd, c_n, r_n, narrow_mask, f"M={slots}", main=False)
    main, _ = k1_case(ro, rd, c, r, mask, f"M={M_SLOTS}", main=True)
    results["march_shade"] = dict(
        max_abs_err=main["cold"]["max_abs_err_t_hit"], ms=main["ms"],
        device_ms=main["device_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
        early_exit={key: main["early_exit"][key] for key in (
            "max_abs_err_t_hit_vs_fixed", "tol_t_vs_fixed", "ms",
            "device_ms", "plain_ms", "bound_ms", "mean_steps_needed")})

    # The kernel that packs K1's table, bitwise against its plain version.
    table_k = k1.pack_march_table(c, r, mask, k)
    table_p = k1.march_table(c, r, mask, k)
    err_pack = (table_k - table_p).abs().max().item()
    check_close(failures, "K1 table pack", err_pack, 0.0)
    results["march_pack"] = dict(
        max_abs_err=err_pack,
        ms=time_ms(torch, lambda: k1.pack_march_table(c, r, mask, k)),
        device_ms=graph_ms(torch,
                           lambda: k1.pack_march_table(c, r, mask, k)),
        plain_ms=time_ms(torch, lambda: k1.march_table(c, r, mask, k)),
        **bound(tensor_bytes(c, r, mask, table_k), flops=6.0 * M_SLOTS),
        library_ms=None)
    emit("kernel", name="march_pack", tol=0.0, **results["march_pack"])

    # The two K2 shapes: the table's (100 live of 128 slots) and the one the
    # config-1 trace runs after a short training (10 of 16).
    k2_case(torch, dev, ro, rd, *K2_NARROW, k, failures)
    results.update(k2_case(torch, dev, ro, rd, M_LIVE, M_SLOTS, k, failures))
    if failures:
        raise AssertionError("; ".join(failures))
    return results


def k2_case(torch, dev, ro, rd, live: int, slots: int, k: float,
            failures: list) -> dict:
    """K2 at one table width: the pack kernel bitwise against its plain
    version, forward and gradients against the plain tail, the backward's
    fixed-order sum over its partial rows against ``sum(0)``, repeats,
    padded slots, times → the rows of the ``kernels`` line."""
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
    from burn_raymarching_tpu_torch.ops.cuda import shade_kernel as k2

    _, _, padded, mask, activate, cot = main_path_inputs(torch, dev, live,
                                                         slots)
    label = f"K2 {live}/{slots}"
    with torch.no_grad():
        c, col, r, ld, amb = activate(padded)
        t_det, n_det = k1.march_shade(ro, rd, c, r, k, mask=mask)
    pairs = float(N_RAYS * live)
    rays_in = (ro, rd, t_det, n_det, c, r, col)
    results = {}

    # The kernel that packs the table, bitwise against its plain version.
    pack_args = (c, r, col, mask, ld, amb)
    table = k2.pack_shade_table(*pack_args)
    err_pack = (table - k2.shade_table(*pack_args)).abs().max().item()
    check_close(failures, f"{label} table pack", err_pack, 0.0)
    results["shade_pack"] = dict(
        max_abs_err=err_pack,
        ms=time_ms(torch, lambda: k2.pack_shade_table(*pack_args)),
        device_ms=graph_ms(torch, lambda: k2.pack_shade_table(*pack_args)),
        plain_ms=time_ms(torch, lambda: k2.shade_table(*pack_args)),
        **bound(tensor_bytes(c, r, col, mask, ld, amb, table),
                flops=6.0 * slots), library_ms=None)
    emit("kernel", name="shade_pack", slots=slots, live=live, tol=0.0,
         **results["shade_pack"])

    # Forward (pack + kernel, as the training step calls it).
    def fwd(fn):
        with torch.no_grad():
            return fn(ro, rd, t_det, n_det, c, r, col, ld, amb, k, mask=mask)

    out_k, out_p = fwd(k2.shade_fused), fwd(k2.shade_plain)
    err_f = (out_k - out_p).abs().max().item()
    check_close(failures, f"{label} forward", err_f, 1e-5)
    # Per (ray, live primitive) pair: a sqrt and an exp for the soft-min at
    # p0, a sqrt and two exps (softmax weight, soft-min) at p; the backward
    # recomputes them. ~30 other FP32 operations forward, ~60 backward.
    results["shade_fwd"] = dict(
        max_abs_err=err_f, ms=time_ms(torch, lambda: fwd(k2.shade_fused)),
        device_ms=graph_ms(torch, lambda: fwd(k2.shade_fused)),
        kernel_device_ms=graph_ms(torch, lambda: k2.launch_shade_fwd(
            ro, rd, t_det, n_det, table, k)),
        plain_ms=time_ms(torch, lambda: fwd(k2.shade_plain)),
        **bound(tensor_bytes(*rays_in, out_k), sfu_ops=5.0 * pairs,
                flops=30.0 * pairs), library_ms=None)
    emit("kernel", name="shade_fwd", slots=slots, live=live, tol=1e-5,
         **results["shade_fwd"])

    # Gradients (all five parameter groups) against autograd of the plain
    # tail; tolerance relative to each group's largest gradient.
    def grads(fn):
        c_, col_, r_, ld_, amb_ = activate(padded)
        out = fn(ro, rd, t_det, n_det, c_, r_, col_, ld_, amb_, k, mask=mask)
        return torch.autograd.grad((out * cot).sum(),
                                   list(padded.parameters()))

    g_k = grads(k2.shade_fused)
    g_p = grads(k2.shade_plain)
    err_g = {}
    for name, a, b in zip(("centers", "colors", "radii", "light_dir",
                           "ambient"), g_k, g_p):
        err = (a - b).abs().max().item()
        tol = 1e-3 * b.abs().max().item() + 1e-6
        check_close(failures, f"{label} grad {name}", err, tol)
        err_g[name] = [err, tol]
    pad_zero = all(bool((g[live:] == 0).all()) for g in g_k[:3])
    if not pad_zero:
        failures.append(f"{label}: gradients of padded slots are not zero")
    deterministic = all(bool(torch.equal(a, b)) for a, b in
                        zip(g_k, grads(k2.shade_fused)))
    if not deterministic:
        failures.append(f"{label}: gradients differ between two runs")

    # The backward launch alone: its fixed-order sum over the partial rows
    # against sum(0) of the same rows, and the l̂ -> light projection.
    bwd_args = (ro, rd, t_det, n_det, table, k, cot)
    *d_all, partial = k2.launch_shade_bwd(*bwd_args)
    total = partial.sum(0)
    m = slots
    lhat, l_norm = table[2 * m, :3], table[2 * m + 1, 0]
    d_lhat = total[7 * m:7 * m + 3]
    want = torch.cat([total[:3 * m].reshape(3, m).T.reshape(-1),
                      total[3 * m:4 * m],
                      total[4 * m:7 * m].reshape(3, m).T.reshape(-1),
                      (d_lhat - lhat * torch.sum(lhat * d_lhat)) / l_norm,
                      total[7 * m + 3:]])
    got = torch.cat([x.reshape(-1) for x in d_all])
    err_red = (got - want).abs().max().item()
    check_close(failures, f"{label} sum over partial rows", err_red,
                1e-5 * partial.abs().sum(0).max().item() + 1e-6)
    c_p, col_p, r_p, ld_p, amb_p = activate(padded)
    out_plain = k2.shade_plain(ro, rd, t_det, n_det, c_p, r_p, col_p, ld_p,
                               amb_p, k, mask=mask)
    params_list = list(padded.parameters())
    bwd_dev = graph_ms(torch, lambda: k2.launch_shade_bwd(*bwd_args))
    no_sum_dev = graph_ms(torch, lambda: k2.launch_shade_bwd(
        *bwd_args, reduce=False))
    results["shade_bwd"] = dict(
        max_abs_err=max(e for e, _ in err_g.values()),
        ms=time_ms(torch, lambda: k2.launch_shade_bwd(*bwd_args)),
        device_ms=bwd_dev,
        plain_ms=time_ms(torch, lambda: torch.autograd.grad(
            out_plain, params_list, cot, retain_graph=True)),
        **bound(tensor_bytes(*rays_in, cot, *d_all), sfu_ops=5.0 * pairs,
                flops=60.0 * pairs),
        # No PyTorch call computes the backward; ``sum(0)`` computes the sum
        # over the partial rows that the launch holds inside.
        library_ms=None, partial_rows=partial.shape[0],
        sum_max_abs_err=err_red, sum_device_ms=bwd_dev - no_sum_dev,
        sum_library_ms=time_ms(torch, lambda: partial.sum(0)),
        sum_library_device_ms=graph_ms(torch, lambda: partial.sum(0)),
        sum_bound_ms=bound(tensor_bytes(partial, total))["bound_ms"])
    emit("kernel", name="shade_bwd", slots=slots, live=live,
         max_abs_err_and_tol=err_g, padded_slots_zero=pad_zero,
         bitwise_repeatable=deterministic, **results["shade_bwd"])
    return results


def knot_cloud(torch, dev, n: int, gt_n: int = C4_GT_N):
    """The prior-seeded cloud init of ``n`` spheres around the generator's
    ``gt_n``-sphere knot (points.json, jitter 0.02), padded to its bucket →
    (padded, mask, centers, radii) with the last two activated and
    detached."""
    from burn_raymarching_tpu_torch.models.scene import (
        activate,
        init_scene_params_cloud,
        pad_params,
    )
    from burn_raymarching_tpu_torch.tools.generate import knot_scene
    from burn_raymarching_tpu_torch.utils import bucket_size

    pts, _, _ = knot_scene(gt_n)
    params = init_scene_params_cloud(n, seed=0, points=pts, jitter=0.02,
                                     device=dev)
    padded, mask = pad_params(params, bucket_size(n))
    c, _, r, _, _ = activate(padded)
    return padded, mask, c.detach(), r.detach()


def c4_tiles(torch, dev, c, r, mask, size: int = C4_SIZE,
             views: int = C4_VIEWS, budget: int = C4_BUDGET):
    """32 tile-coherent ray tiles of the config-4 rig (or another knot rig
    of ``views`` views at ``size``²) and their top-K tables: Morton tiles
    of 4 random views, selected against the whole primitive table, 32
    picked among those whose selection is not empty."""
    import numpy as np

    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching_tpu_torch.tools.generate import ring_cameras
    from burn_raymarching_tpu_torch.utils import morton_permutation

    rng = np.random.default_rng(0)
    perm = torch.as_tensor(morton_permutation(size, size), device=dev)
    cams = ring_cameras(views)
    ro_all, rd_all = [], []
    for v in rng.choice(views, 4, replace=False):
        ro, rd = create_camera_rays(size, size, cams[v]["origin"],
                                    cams[v]["target"], cams[v]["fov"],
                                    device=dev)
        ro_all.append(ro[perm])
        rd_all.append(rd[perm])
    ro, rd = torch.cat(ro_all), torch.cat(rd_all)
    idx, valid = select_tile_primitives(tile_cones(ro, rd, C4_TILE), c, r,
                                        C4_K, budget, mask=mask)
    live = torch.nonzero(valid.sum(dim=1) > 0)[:, 0].cpu().numpy()
    pick = torch.as_tensor(np.sort(rng.choice(live, C4_TILES,
                                              replace=False)), device=dev)
    idx, valid = idx[pick], valid[pick]
    cs = c[idx]
    rs = r.reshape(-1)[idx]
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    ro3 = ro.reshape(-1, C4_TILE, 3)[pick].contiguous()
    rd3 = rd.reshape(-1, C4_TILE, 3)[pick].contiguous()
    counts = valid.sum(dim=1)
    return (ro3, rd3, cs, rs, qs), {"valid_per_tile_min": int(counts.min()),
                                    "valid_per_tile_max": int(counts.max()),
                                    "valid_slots": int(counts.sum())}


def chunked_tiles(torch, dev, ro3, rd3):
    """K3 inputs for its chunked path: the first CHUNKED_TILES ray tiles,
    each against the same CHUNKED_K live primitives drawn evenly from the
    51,200-sphere cloud (more columns than the resident table holds)."""
    _, _, c, r = knot_cloud(torch, dev, LARGE_INIT_N)
    pick = torch.arange(0, LARGE_INIT_N, LARGE_INIT_N // CHUNKED_K,
                        device=dev)[:CHUNKED_K]
    cs = c[pick][None].expand(CHUNKED_TILES, -1, -1).contiguous()
    rs = r.reshape(-1)[pick][None].expand(CHUNKED_TILES, -1).contiguous()
    return (ro3[:CHUNKED_TILES].contiguous(),
            rd3[:CHUNKED_TILES].contiguous(), cs, rs,
            torch.sum(cs * cs, dim=2))


def full_tables(torch, args, c, r, mask):
    """K3 inputs of the first 4 ray tiles, each against the first C4_BUDGET
    live primitives: every slot of the tables valid."""
    ids = torch.nonzero(mask.reshape(-1))[:C4_BUDGET, 0]
    cs = c[ids][None].expand(4, -1, -1).contiguous()
    rs = r.reshape(-1)[ids][None].expand(4, -1).contiguous()
    return (args[0][:4].contiguous(), args[1][:4].contiguous(), cs, rs,
            torch.sum(cs * cs, dim=2))


def k6_inputs(torch, dev, args):
    """K6's inputs on K3's tiles and tables (ro3, rd3, cs, rs, qs): t and
    normal from K3's cold march, colours drawn from a fixed seed, config 4's
    light and ambient at init → (ro3, rd3, t, normal, cs, colours, rs,
    valid, light, ambient) and a cotangent of the output."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3

    ro3, rd3, cs, rs, qs = args
    gen = torch.Generator().manual_seed(6)
    cols = torch.rand(cs.shape, generator=gen).to(dev)
    cot = torch.randn((ro3.shape[0] * ro3.shape[1], 3), generator=gen).to(dev)
    t, normal = k3.culled_march_normals(*args, C4_K)
    light = torch.tensor([0.3, 1.0, -0.4], device=dev)
    amb = torch.tensor([0.2], device=dev)
    return (ro3, rd3, t, normal, cs, cols, rs, qs < 1e29, light, amb), cot


# Config 4's compositor: softmax and coverage sharpness.
C4_SHARPNESS = (40.0, 60.0)
K6_GRADS = ("d_centers", "d_colors", "d_radii", "d_light", "d_ambient")


def k6_run(torch, tail, inp, cot, dtype=None) -> list:
    """The culled tail ``tail`` (k6.culled_shade or its plain version) on
    ``inp``, in ``dtype`` → [out, its five gradients under sum(out cot)]."""
    dtype = dtype or torch.float32
    ro3, rd3, t, normal, cs, cols, rs, valid, light, amb = inp
    leaves = [x.to(dtype).clone().requires_grad_()
              for x in (cs, cols, rs, light, amb)]
    out = tail(ro3.to(dtype), rd3.to(dtype), t.to(dtype), normal.to(dtype),
               leaves[0], leaves[1], leaves[2], valid, leaves[3], leaves[4],
               C4_K, *C4_SHARPNESS)
    grads = torch.autograd.grad(torch.sum(out * cot.to(dtype)), leaves)
    return [out.detach(), *grads]


def k6_case(torch, dev, args, label: str, failures: list) -> dict:
    """K6 on K3's tiles: value and gradients against the plain tail within
    5x the plain version's float32 gap to float64 + 1e-5 (the rule of K3's
    and K5's tolerances), a repeat bitwise equal; each launch timed alone,
    the plain tail's forward and forward + backward → errors, times,
    bounds."""
    from burn_raymarching_tpu_torch.ops.cuda import build
    from burn_raymarching_tpu_torch.ops.cuda import culled_shade_kernel as k6

    inp, cot = k6_inputs(torch, dev, args)
    got = k6_run(torch, k6.culled_shade, inp, cot)
    plain = k6_run(torch, k6.culled_shade_plain, inp, cot)
    plain64 = k6_run(torch, k6.culled_shade_plain, inp, cot, torch.float64)
    again = k6_run(torch, k6.culled_shade, inp, cot)
    errs, tols = {}, {}
    for name, g, p, p64, a in zip(("out",) + K6_GRADS, got, plain, plain64,
                                  again):
        errs[name] = (g - p).abs().max().item()
        tols[name] = 5.0 * (p.double() - p64).abs().max().item() + 1e-5
        check_close(failures, f"K6 {label} {name}", errs[name], tols[name])
        if not torch.equal(g, a):
            failures.append(f"K6 {label} {name}: a repeat differs")
    ro3, rd3, t, normal, cs, cols, rs, valid, light, amb = inp
    k = build.device_scalar(C4_K, dev)
    kern = (ro3, rd3, t, normal, cs, cols, rs, valid, light, amb, k)

    def fwd():
        return k6.launch_ctail_fwd(*kern, *C4_SHARPNESS)

    out, state = fwd()

    def bwd():
        return k6.launch_ctail_bwd(*kern, state, cot, *C4_SHARPNESS)

    leaves = [x.clone().requires_grad_() for x in (cs, cols, rs, light, amb)]

    def plain_fwd():
        return k6.culled_shade_plain(ro3, rd3, t, normal, *leaves[:3], valid,
                                     *leaves[3:], C4_K, *C4_SHARPNESS)

    def plain_fwd_bwd():
        torch.autograd.grad(torch.sum(plain_fwd() * cot), leaves)

    # Per (ray, valid slot) pair 5 SFU operations forward and 5 backward,
    # as counts.py counts K2's tail (this backward makes ~10: it recomputes
    # the distances).
    b, tile, slots = ro3.shape[0], ro3.shape[1], valid.shape[1]
    valid_slots = int(valid.sum())
    pairs = float(tile * valid_slots)
    rays = tensor_bytes(ro3, rd3, t, normal, cot)
    table = tensor_bytes(cs, cols, rs, valid)
    fwd_bytes = rays - tensor_bytes(cot) + table + tensor_bytes(out, state)
    bwd_bytes = rays + table + tensor_bytes(state, cs, cols, rs)
    fwd_ms, bwd_ms = time_ms(torch, fwd), time_ms(torch, bwd)
    fwd_dev, bwd_dev = graph_ms(torch, fwd), graph_ms(torch, bwd)
    plain_fwd_ms = time_ms(torch, plain_fwd, reps=5)
    plain_ms = time_ms(torch, plain_fwd_bwd, reps=5)
    plain_dev = graph_ms(torch, plain_fwd_bwd, launches=2, reps=3)
    case = dict(tiles=b, rays_per_tile=tile, table=slots,
                valid_slots=valid_slots,
                live_columns_max=int(valid.sum(dim=1).max()),
                errs=errs, tol=tols, fwd_ms=fwd_ms, fwd_device_ms=fwd_dev,
                bwd_ms=bwd_ms, bwd_device_ms=bwd_dev,
                plain_fwd_ms=plain_fwd_ms, plain_ms=plain_ms,
                plain_device_ms=plain_dev,
                fwd_bound=bound(fwd_bytes, sfu_ops=5.0 * pairs),
                bwd_bound=bound(bwd_bytes, sfu_ops=5.0 * pairs),
                bound_if_all_slots_valid=bound(
                    fwd_bytes, sfu_ops=5.0 * b * tile * slots))
    emit("kernel", name=f"culled_shade_{label}", **case)
    return case


# K7's shapes, on config 4's 32 ray tiles: (label, seeded spheres, rows,
# K). The step's table (5,120 spheres in 8,192 slots, K = 2,048); a later
# stage's prefill, whose ~1,340 spheres fill 2,048 slots and K holds every
# row; the bench flagship's prefill (51,200 rows, K = 256), where tiles keep
# more rows than K and than shared memory holds.
K7_SHAPES = (("c4_step", C4_INIT_N, None, C4_BUDGET),
             ("c4_prefill", 1340, None, C4_BUDGET),
             ("flagship", LARGE_INIT_N, LARGE_INIT_N, 256))
# Scores this close (relative to 1 + |score|) may be ordered, or cut, apart
# by the kernel and the plain selection: the two round a few operations
# differently (PyTorch's reduction orders).
K7_SCORE_TOL = 1e-6
# K7's cones (apex, axis, cos_half, origin_spread) against tile_cones': the
# kernel sums the means in another order. The slots are held against the
# plain selection on K7's own cones (K7_SCORE_TOL), so a wrong cone fails
# here: on config 4's narrow tiles a cone gap of ~4e-7 already moves scores
# by ~2e-5 of 1 + |score|, which puts the slots past K7_SCORE_TOL.
K7_CONE_TOL = 1e-6


def k7_compare(torch, ro, rd, c, r, k, budget, mask, out) -> dict:
    """K7's output ``out`` (launch_tile_select's six tensors, with_cones)
    against the plain selection (select_tile_primitives) run on K7's own
    cones: every slot equal but where a score lies within K7_SCORE_TOL of
    the one the plain table holds there (a swap of near-equal neighbours),
    of the tile's cutoff or, in a tile keeping more than K, of its K-th
    score; the invalid tail ascending; cs, rs, qs bitwise the gathers of
    K7's idx; the cones within K7_CONE_TOL of tile_cones' → counts ("bad"
    must be 0)."""
    import numpy as np

    from burn_raymarching_tpu_torch.ops.culling import (
        CULL_MARGIN,
        TileCones,
        cone_point_distance,
        select_tile_primitives,
        selected_tables,
        tile_cones,
    )

    idx, valid, cs, rs, qs, cones = out
    tile = ro.shape[0] // idx.shape[0]
    own = TileCones(cones[:, 0:3], cones[:, 3:6], cones[:, 6], cones[:, 7])
    cone_gap = max(float((a - b).abs().max())
                   for a, b in zip(own, tile_cones(ro, rd, tile)))
    idx_p, valid_p = select_tile_primitives(own, c, r, k, budget, mask=mask)
    score = cone_point_distance(own, c) - r.reshape(1, -1)
    cutoff = CULL_MARGIN / float(k) + own.origin_spread
    kept = score <= cutoff[:, None]
    if mask is not None:
        kept = kept & mask.reshape(1, -1).bool()
    s, cut = score.cpu().numpy(), cutoff.cpu().numpy()
    n_kept = kept.sum(dim=1).cpu().numpy()
    ik, vk = idx.cpu().numpy(), valid.cpu().numpy()
    ip, vp = idx_p.cpu().numpy(), valid_p.cpu().numpy()
    kk = ik.shape[1]

    def near(x, y):
        return abs(float(x) - float(y)) <= K7_SCORE_TOL * (1.0 + abs(float(y)))

    bad = near_swaps = 0
    for b in np.nonzero((ik != ip).any(axis=1) | (vk != vp).any(axis=1))[0]:
        kth = s[b, ip[b, kk - 1]] if n_kept[b] > kk else None
        for j in np.nonzero((ik[b] != ip[b]) | (vk[b] != vp[b]))[0]:
            a, p = ik[b, j], ip[b, j]
            if vk[b, j] and vp[b, j]:
                ok = near(s[b, a], s[b, p])
            elif vk[b, j] or vp[b, j]:
                row = a if vk[b, j] else p
                ok = near(s[b, row], cut[b]) or (
                    kth is not None and near(s[b, row], kth))
            else:
                # Two invalid rows: the tails differ only if the kept sets do.
                ok = not np.array_equal(np.sort(ik[b][vk[b]]),
                                        np.sort(ip[b][vp[b]]))
            bad += not ok
            near_swaps += 1
    tail_ascending = all(bool(np.all(np.diff(ik[b][~vk[b]]) > 0))
                         for b in range(ik.shape[0]))
    gathers = all(torch.equal(a, b) for a, b in
                  zip((cs, rs, qs), selected_tables(c, r, idx, valid)))
    bad += ((not tail_ascending) + (not gathers)
            + (not cone_gap <= K7_CONE_TOL))
    return {"bad": int(bad), "slots_apart_within_tol": int(near_swaps),
            "tiles_equal": int(((ik == ip).all(axis=1)
                                & (vk == vp).all(axis=1)).sum()),
            "tiles": int(ik.shape[0]), "tail_ascending": tail_ascending,
            "gathers_bitwise": gathers, "cone_max_abs_gap": cone_gap,
            "kept_per_tile_max": int(n_kept.max()),
            "tiles_over_k": int((n_kept > kk).sum()),
            "valid_slots": int(vk.sum())}


def k7_bound(ro, rows: int, tiles: int, slots: int) -> dict:
    """K7's least time: the rays, the table (centers, radius, mask byte)
    and the K slots written (idx 8, valid 1, cs 12, rs 4, qs 4 bytes) once;
    per (tile, row) 3 SFU operations (two sqrt, a divide) and ~25 other
    FP32 ones, per ray 1 sqrt and ~20 FP32 for the cone."""
    rays = ro.shape[0]
    return bound(2 * tensor_bytes(ro) + 17.0 * rows + 29.0 * tiles * slots,
                 sfu_ops=3.0 * tiles * rows + rays,
                 flops=25.0 * tiles * rows + 20.0 * rays)


def k7_cases(torch, dev, args, c4_c, c4_r, c4_mask, failures: list) -> dict:
    """K7 at K7_SHAPES on config 4's tiles (K3's inputs ``args``): checked
    by k7_compare, a repeat and a replay of a captured launch bitwise equal,
    timed (wrapper, device, plain) → the kernel table's row (the step's
    shape) with the other shapes' figures beside it."""
    from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7

    ro, rd = args[0].reshape(-1, 3), args[1].reshape(-1, 3)
    tiles = args[0].shape[0]
    row = {}
    for label, n, rows, budget in K7_SHAPES:
        if n == C4_INIT_N:
            c, r, mask = c4_c, c4_r, c4_mask
        else:
            _, mask, c, r = knot_cloud(torch, dev, n)
        if rows is not None:
            c, r, mask = (c[:rows].contiguous(), r[:rows].contiguous(),
                          mask[:rows].contiguous())
        call = (ro, rd, C4_TILE, c, r, C4_K, budget, mask)
        before = k7.launch_tile_select.launches
        out = k7.launch_tile_select(*call, with_cones=True)
        launches = k7.launch_tile_select.launches - before
        torch.cuda.synchronize()
        cmp = k7_compare(torch, ro, rd, c, r, C4_K, budget, mask, out)
        again = k7.launch_tile_select(*call, with_cones=True)
        static = [x.clone() for x in again]
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                captured = k7.launch_tile_select(*call, with_cones=True)
        graph.replay()
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(out, static))
        replay = all(torch.equal(a, b) for a, b in zip(out, captured))
        if cmp["bad"] or not repeat or not replay:
            failures.append(f"K7 {label}: {cmp}, repeat {repeat}, graph "
                            f"replay {replay}")
        kk = out[0].shape[1]
        case = dict(rows=int(c.shape[0]), live=int(mask.sum()), table=kk,
                    **cmp, repeat_bitwise=repeat, replay_bitwise=replay,
                    launches_per_call=launches,
                    ms=time_ms(torch, lambda: k7.tile_select(*call)),
                    device_ms=graph_ms(
                        torch, lambda: k7.launch_tile_select(*call)),
                    plain_ms=time_ms(
                        torch, lambda: k7.tile_select_plain(*call), reps=5),
                    plain_device_ms=graph_ms(
                        torch, lambda: k7.tile_select_plain(*call),
                        launches=2, reps=3),
                    **k7_bound(ro, int(c.shape[0]), tiles, kk))
        emit("kernel", name=f"tile_select_{label}", rays_per_tile=C4_TILE,
             smooth_k=C4_K, **case)
        row[label] = case
    main = row["c4_step"]
    return dict(max_abs_err=None, mismatches_outside_tol=main["bad"],
                slots_apart_within_tol=main[
                    "slots_apart_within_tol"],
                ms=main["ms"], device_ms=main["device_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                **{f"{label}_{key}": row[label][key]
                   for label in ("c4_prefill", "flagship")
                   for key in ("device_ms", "plain_ms", "bound_ms")})


# K4 tolerances, relative to the plain value or the plain gradient's
# largest entry: float32 sums of 2.6 M (C = 80) to 67 M (C = 800) pair
# terms, taken in another order.
K4_TOLS = {"value_rel": 1e-4, "grad_rel_to_max": 1e-4}


def k4_case(torch, dev, n: int, far_field: str, failures: list) -> dict:
    """K4 at ``n`` knot-seeded primitives with the main path's frozen static
    prep: the kernels against autograd of the plain planes sum, the whole
    wrapper against train/loss.cluster_repulsion, the sums over blocks that
    the launches hold inside against one PyTorch call, bitwise repeats,
    times."""
    from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4
    from burn_raymarching_tpu_torch.ops.culling import build_clusters
    from burn_raymarching_tpu_torch.train.loss import (
        build_repulsion_static,
        cluster_repulsion,
    )

    _, mask, c, _ = knot_cloud(torch, dev, n)
    clusters = build_clusters(c.cpu().numpy(), mask=mask.cpu().numpy(),
                              group=64, device=dev)
    static = build_repulsion_static(c, clusters, mask)
    n_valid = mask.float().sum()
    label = f"K4 {far_field} C={clusters.member_idx.shape[0]}"
    out = {"clusters": clusters.member_idx.shape[0],
           "far_field": far_field, "tol": K4_TOLS}

    # Whole wrapper (prep + kernels) against the plain cluster_repulsion.
    def value_grad(fn):
        cc = c.clone().requires_grad_()
        v = fn(cc, clusters, mask, n_valid, far_field=far_field,
               static=static)
        (g,) = torch.autograd.grad(v, [cc])
        return v.detach(), g

    v_k, g_k = value_grad(k4.cluster_repulsion_fused)
    v_p, g_p = value_grad(cluster_repulsion)
    out["wrapper_value_abs_err"] = abs(v_k - v_p).item()
    out["wrapper_value_rel_err"] = (out["wrapper_value_abs_err"]
                                    / abs(v_p).item())
    out["wrapper_grad_max_abs_err"] = (g_k - g_p).abs().max().item()
    out["wrapper_grad_err_rel_to_max"] = (out["wrapper_grad_max_abs_err"]
                                          / g_p.abs().max().item())

    # The kernels alone against autograd of the plain planes sum.
    include_far = far_field != "monopole"
    planes, *_ = k4.repulsion_planes(c, clusters, mask, static=static)
    leaves = [x.clone().requires_grad_() for x in planes[:3]]
    s_p = k4.repulsion_sum_plain(*leaves, *planes[3:], include_far)
    grads_p = [torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves, torch.autograd.grad(
                   s_p, leaves, retain_graph=True, allow_unused=True))]
    s_k, partial = k4.launch_rep_fwd(*planes, include_far)
    g1 = torch.ones((1,), device=dev)
    first = k4.launch_rep_bwd(*planes, g1, include_far)
    second = k4.launch_rep_bwd(*planes, g1, include_far)
    out["blocks"] = partial.numel()
    out["bitwise_repeatable"] = all(
        torch.equal(a, b) for a, b in zip(first, second) if a is not None
    ) and torch.equal(s_k, k4.launch_rep_fwd(*planes, include_far)[0])
    if not out["bitwise_repeatable"]:
        failures.append(f"{label}: results differ between two runs")
    d_cs, d_nb, d_cents, cent_part = first
    if not include_far:
        d_cents = torch.zeros_like(grads_p[2])
    out["fwd_value_abs_err"] = abs(s_k - s_p).item()
    out["fwd_value_rel_err"] = out["fwd_value_abs_err"] / abs(s_p).item()
    out["bwd_grad_max_abs_err"] = max(
        (a - b).abs().max().item()
        for a, b in zip((d_cs, d_nb, d_cents), grads_p))
    out["bwd_grad_err_rel_to_max"] = out["bwd_grad_max_abs_err"] / max(
        g.abs().max().item() for g in grads_p)
    for key, tol in (("wrapper_value_rel_err", "value_rel"),
                     ("fwd_value_rel_err", "value_rel"),
                     ("wrapper_grad_err_rel_to_max", "grad_rel_to_max"),
                     ("bwd_grad_err_rel_to_max", "grad_rel_to_max")):
        check_close(failures, f"{label} {key}", out[key], K4_TOLS[tol])

    # The sums that the launches hold inside, against one PyTorch call on
    # the same parts: the forward's scalar over its blocks, the backward's
    # d_centroids over the clusters.
    out["fwd_sum_rel_err"] = (abs(s_k - partial.sum()) / abs(s_k)).item()
    check_close(failures, f"{label} forward sum over blocks",
                out["fwd_sum_rel_err"], 1e-6)
    if include_far:
        out["bwd_sum_abs_err"] = (d_cents - cent_part.sum(0)).abs().max(
            ).item()
        out["bwd_sum_rel_err"] = (out["bwd_sum_abs_err"]
                                  / cent_part.abs().sum(0).max().item())
        check_close(failures, f"{label} d_centroids sum over clusters",
                    out["bwd_sum_rel_err"], 1e-6)

    def fwd(**kw):
        return k4.launch_rep_fwd(*planes, include_far, **kw)

    def bwd(**kw):
        return k4.launch_rep_bwd(*planes, g1, include_far, **kw)

    with torch.no_grad():
        out["fwd_ms"] = time_ms(torch, fwd)
        out["fwd_device_ms"] = graph_ms(torch, fwd)
        out["fwd_sum_device_ms"] = out["fwd_device_ms"] - graph_ms(
            torch, lambda: fwd(reduce=False))
        out["fwd_sum_library_ms"] = time_ms(torch, lambda: partial.sum())
        out["fwd_sum_library_device_ms"] = graph_ms(torch,
                                                    lambda: partial.sum())
        out["fwd_plain_ms"] = time_ms(torch, lambda: k4.repulsion_sum_plain(
            *planes, include_far))
    out["bwd_ms"] = time_ms(torch, bwd)
    out["bwd_device_ms"] = graph_ms(torch, bwd)
    out["bwd_plain_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        s_p, leaves, retain_graph=True, allow_unused=True))
    if include_far:
        out["bwd_sum_device_ms"] = out["bwd_device_ms"] - graph_ms(
            torch, lambda: bwd(reduce=False))
        out["bwd_sum_library_ms"] = time_ms(torch, lambda: cent_part.sum(0))
        out["bwd_sum_library_device_ms"] = graph_ms(
            torch, lambda: cent_part.sum(0))
        out["bwd_sum_bound_ms"] = bound(tensor_bytes(cent_part, d_cents))[
            "bound_ms"]
    # Per pair a sqrt and a reciprocal, forward and backward, among ~12
    # (forward) and ~25 (backward) other FP32 operations.
    c_dim, g_dim = planes[0].shape[1], planes[0].shape[2]
    pairs = float(c_dim * g_dim * (planes[1].shape[2]
                                   + (planes[2].shape[1] if include_far
                                      else 0)))
    out["pairs"] = pairs
    out["fwd_bound"] = bound(tensor_bytes(*planes, s_k),
                             sfu_ops=2.0 * pairs, flops=12.0 * pairs)
    out["bwd_bound"] = bound(tensor_bytes(*planes, d_cs, d_nb,
                                          first[2]),
                             sfu_ops=2.0 * pairs, flops=25.0 * pairs)
    return out


def phase_kernels_c4(torch, dev) -> dict:
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )

    failures = []
    _, mask, c, r = knot_cloud(torch, dev, C4_INIT_N)
    args, table_stats = c4_tiles(torch, dev, c, r, mask)
    args64 = [a.double() for a in args]
    t_init = None
    errs, tols = {}, {}
    for label, steps in (("cold", 40), ("warm16", 16)):
        kw = dict(num_steps=steps, t_init=t_init)
        t_k, n_k = k3.culled_march_normals(*args, C4_K, **kw)
        t_p, n_p = culled_march_normals_xla(*args, C4_K, **kw)
        t_64, n_64 = culled_march_normals_xla(
            *args64, C4_K, num_steps=steps,
            t_init=None if t_init is None else t_init.double())
        errs[label] = march_errors(torch, t_k, n_k, t_p, n_p)
        errs[label].update(float64_gaps(torch, t_k, n_k, t_p, n_p, t_64,
                                        n_64))
        tols[label] = march_noise_tols(torch, t_p, n_p, t_64, n_64)
        for key, tol in tols[label].items():
            check_close(failures, f"K3 {label} {key}", errs[label][key], tol)
        if t_init is None:
            t_init = (t_p * 0.8).contiguous()
    cold, warm = errs["cold"], errs["warm16"]
    warm_kw = dict(num_steps=16, t_init=t_init)
    ms = time_ms(torch, lambda: k3.culled_march_normals(*args, C4_K,
                                                        **warm_kw))
    plain_ms = time_ms(torch, lambda: culled_march_normals_xla(
        *args, C4_K, **warm_kw), reps=5)
    cold_ms = time_ms(torch, lambda: k3.culled_march_normals(*args, C4_K))
    cold_plain_ms = time_ms(torch, lambda: culled_march_normals_xla(
        *args, C4_K), reps=5)
    device_ms = graph_ms(torch, lambda: k3.culled_march_normals(
        *args, C4_K, **warm_kw))
    cold_device_ms = graph_ms(torch, lambda: k3.culled_march_normals(
        *args, C4_K))
    # The work this run's tables need: each ray against its tile's valid
    # slots, 16 + 7 (warm) or 40 + 7 (cold) evaluations.
    pairs = float(C4_TILE * table_stats["valid_slots"])
    warm_bound = march_bound(23.0 * pairs, *args, t_init, t_k, n_k)
    cold_bound = march_bound(47.0 * pairs, *args, t_k, n_k)
    emit("kernel", name="culled_march", tiles=C4_TILES, rays_per_tile=C4_TILE,
         table=C4_BUDGET, smooth_k=C4_K, **table_stats, cold=cold,
         warm16=warm, tol=tols, warm16_ms=ms, warm16_plain_ms=plain_ms,
         cold_ms=cold_ms, cold_plain_ms=cold_plain_ms,
         warm16_device_ms=device_ms, cold_device_ms=cold_device_ms,
         warm16_bound=warm_bound, cold_bound=cold_bound,
         warm16_bound_if_all_slots_live=march_bound(
             23.0 * C4_TILES * C4_TILE * C4_BUDGET, *args, t_init, t_k, n_k))
    # ms, device_ms and bound_ms are the warm launch's (one per training
    # step); most of a short run's launches are the prefill's cold ones, so
    # those stand beside them.
    results = {"culled_march": dict(max_abs_err=warm["max_abs_err_t_hit"],
                                    ms=ms, device_ms=device_ms,
                                    plain_ms=plain_ms, **warm_bound,
                                    library_ms=None, cold_ms=cold_ms,
                                    cold_device_ms=cold_device_ms,
                                    cold_plain_ms=cold_plain_ms,
                                    cold_bound_ms=cold_bound["bound_ms"],
                                    cold_max_abs_err=cold[
                                        "max_abs_err_t_hit"])}

    # The chunked path: more live columns than the resident table holds.
    ch_args = chunked_tiles(torch, dev, args[0], args[1])
    ch_kw = dict(num_steps=16)
    t_k, n_k = k3.culled_march_normals(*ch_args, C4_K, **ch_kw)
    t_p, n_p = culled_march_normals_xla(*ch_args, C4_K, **ch_kw)
    t_64, n_64 = culled_march_normals_xla(*[a.double() for a in ch_args],
                                          C4_K, **ch_kw)
    ch_errs = march_errors(torch, t_k, n_k, t_p, n_p)
    ch_errs.update(float64_gaps(torch, t_k, n_k, t_p, n_p, t_64, n_64))
    ch_tols = march_noise_tols(torch, t_p, n_p, t_64, n_64)
    for key, tol in ch_tols.items():
        check_close(failures, f"K3 chunked {key}", ch_errs[key], tol)
    emit("kernel", name="culled_march_chunked", tiles=CHUNKED_TILES,
         rays_per_tile=C4_TILE, live_columns=CHUNKED_K, smooth_k=C4_K,
         num_steps=16, errs=ch_errs, tol=ch_tols,
         ms=time_ms(torch, lambda: k3.culled_march_normals(
             *ch_args, C4_K, **ch_kw)),
         device_ms=graph_ms(torch, lambda: k3.culled_march_normals(
             *ch_args, C4_K, **ch_kw)),
         plain_ms=time_ms(torch, lambda: culled_march_normals_xla(
             *ch_args, C4_K, **ch_kw), reps=3),
         **march_bound(23.0 * CHUNKED_TILES * C4_TILE * CHUNKED_K, *ch_args,
                       t_k, n_k))

    # K6 on the same tiles (config 4's main path), then on full tables.
    k6_main = k6_case(torch, dev, args, "c4", failures)
    k6_full = k6_case(torch, dev, full_tables(torch, args, c, r, mask),
                      "full_tables", failures)
    for part in ("fwd", "bwd"):
        errs = k6_main["errs"]
        results[f"culled_shade_{part}"] = dict(
            max_abs_err=(errs["out"] if part == "fwd" else
                         max(errs[g] for g in K6_GRADS)),
            ms=k6_main[f"{part}_ms"], device_ms=k6_main[f"{part}_device_ms"],
            plain_ms=(k6_main["plain_fwd_ms"] if part == "fwd" else
                      k6_main["plain_ms"] - k6_main["plain_fwd_ms"]),
            **k6_main[f"{part}_bound"], library_ms=None,
            full_tables_device_ms=k6_full[f"{part}_device_ms"])

    results["tile_select"] = k7_cases(torch, dev, args, c, r, mask,
                                      failures)

    cases = {}
    for n, far_field in ((C4_INIT_N, "member"), (C4_INIT_N, "monopole"),
                         (LARGE_INIT_N, "member"),
                         (LARGE_INIT_N, "monopole")):
        case = k4_case(torch, dev, n, far_field, failures)
        emit("kernel", name="repulsion", **case)
        cases[(n, far_field)] = case
    # Errors of the repulsion term as the loss sees it (the sum over
    # n_valid^2, and its gradient in the centers). No PyTorch call computes
    # the kernels' function; ``sum`` computes the sums over blocks that the
    # launches hold inside (the ``sum_*`` fields).
    main = cases[(C4_INIT_N, "member")]
    results["repulsion_fwd"] = dict(
        max_abs_err=main["wrapper_value_abs_err"],
        max_rel_err=main["wrapper_value_rel_err"], ms=main["fwd_ms"],
        device_ms=main["fwd_device_ms"], plain_ms=main["fwd_plain_ms"],
        **main["fwd_bound"], library_ms=None, blocks=main["blocks"],
        sum_device_ms=main["fwd_sum_device_ms"],
        sum_library_ms=main["fwd_sum_library_ms"],
        sum_library_device_ms=main["fwd_sum_library_device_ms"])
    results["repulsion_bwd"] = dict(
        max_abs_err=main["wrapper_grad_max_abs_err"],
        max_rel_err=main["wrapper_grad_err_rel_to_max"], ms=main["bwd_ms"],
        device_ms=main["bwd_device_ms"], plain_ms=main["bwd_plain_ms"],
        **main["bwd_bound"], library_ms=None,
        sum_max_abs_err=main["bwd_sum_abs_err"],
        sum_device_ms=main["bwd_sum_device_ms"],
        sum_library_ms=main["bwd_sum_library_ms"],
        sum_library_device_ms=main["bwd_sum_library_device_ms"],
        sum_bound_ms=main["bwd_sum_bound_ms"])
    if failures:
        raise AssertionError("; ".join(failures))
    return results


def step_runner(torch, trainer, final, mask, t_cache=None,
                graphs: bool = True, seed: int = 1):
    """The trainer's full step (sample, forward, loss, backward, Adam) on a
    fresh copy of the padded ``final`` params, with the trainer's sampling
    pools, cluster table, frozen repulsion prep and a copy of ``t_cache``
    (for warm-started configs), as run_stage sets it up → a ChunkRunner
    (train/chunk.py): a captured CUDA graph of one step with ``graphs``,
    else one step at a time."""
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        unpad_params,
    )
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer

    cfg, ds = trainer.cfg, trainer.dataset
    padded, _ = pad_params(unpad_params(final, int(mask.sum())), final.n)
    gen = torch.Generator(device=ds.device)
    gen.manual_seed(seed)
    clusters = trainer._build_cluster_table(padded, mask)
    fg_pool, n_fg = trainer._sample_fg
    runner = ChunkRunner(
        trainer.step_fn, padded, make_optimizer(cfg, padded),
        trainer.lr_scales, cfg.stages - 1, mask, ds.packed, fg_pool, n_fg,
        gen, t_cache=None if t_cache is None else t_cache.clone(),
        clusters=clusters, graphs=graphs)
    if cfg.cluster_repulsion:
        runner.refresh_static(build_repulsion_static(padded.centers,
                                                     clusters, mask))
    return runner


def step_rate(torch, trainer, final, mask, steps: int = 30,
              t_cache=None, graphs: bool = True) -> float:
    """Steady-state rays/s of ``step_runner``'s step after 5 warm-up steps
    (with ``graphs``, the capture among them), host clock around
    synchronized work."""
    runner = step_runner(torch, trainer, final, mask, t_cache, graphs)
    runner.run(1, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run(6, steps)
    torch.cuda.synchronize()
    rate = steps * trainer.cfg.batch_size / (time.perf_counter() - t0)
    runner.close()
    return rate


def device_profile(torch, trainer, final, mask, t_cache, steps: int = 10,
                   graphs: bool = True) -> dict:
    """tools/device_time.profile_calls (torch.profiler's device-busy time
    per step, the top device ops and the host's launch calls per step) over
    ``steps`` steady training steps of ``step_runner``."""
    from burn_raymarching_tpu_torch.tools.device_time import profile_calls

    runner = step_runner(torch, trainer, final, mask, t_cache, graphs)
    runner.run(1, 3)
    out = profile_calls(lambda i: runner.run(4 + i, 1), steps)
    runner.close()
    return out


# The hand kernels as the trace names them (tools/device_time.HAND_KERNELS)
# → their wrappers' names in the kernels line.
TRACE_NAMES = {"march_shade_kernel": "march_shade",
               "march_pack_kernel": "march_pack",
               "shade_pack_kernel": "shade_pack",
               "shade_fwd_kernel": "shade_fwd",
               "shade_bwd_kernel": "shade_bwd",
               "culled_march_kernel": "culled_march",
               "ctail_fwd_kernel": "culled_shade_fwd",
               "ctail_bwd_kernel": "culled_shade_bwd",
               "rep_fwd_kernel": "repulsion_fwd",
               "rep_bwd_kernel": "repulsion_bwd",
               "tile_select_kernel": "tile_select"}
CHUNK_STEPS = 100


def phase_chunk(torch, label: str, trainer, final, mask, t_cache=None
                ) -> dict:
    """One CHUNK_STEPS-step chunk of ``trainer``'s step replayed from a
    captured CUDA graph, and the same chunk run one step at a time, twice,
    all from the same state and generator: the batch indices of every step
    (recorded on the device, inside the graph too) must match bitwise, and
    the captured chunk's largest parameter difference to the first plain
    run must stay within 2x the two plain runs' own difference (bitwise
    where they are bitwise). Then, plain beside captured: wall ms per step
    over a second chunk, and over 20 steps device-busy ms, the busy share
    and the host's launch calls per step (tools/device_time), with each
    hand kernel's trace events held to its launch count."""
    import burn_raymarching_tpu_torch.train.step_body as sb
    from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS
    from burn_raymarching_tpu_torch.tools.device_time import profile_calls

    cfg = trainer.cfg
    dev = trainer.device
    n_unique = cfg.batch_size // max(1, int(cfg.render.supersample))
    rec = torch.zeros((CHUNK_STEPS + 1, n_unique), dtype=torch.int64,
                      device=dev)
    pos = torch.zeros((1,), dtype=torch.int64, device=dev)
    sample = sb.sample_step_indices

    def recording(*args, **kw):
        idx = sample(*args, **kw)
        rec.index_copy_(0, pos, idx[None])
        pos.add_(1)
        return idx

    runs = {}
    sb.sample_step_indices = recording
    try:
        for mode in ("plain", "plain_again", "graph"):
            pos.zero_()
            runner = step_runner(torch, trainer, final, mask, t_cache,
                                 graphs=mode == "graph")
            runner.run(1, CHUNK_STEPS)
            torch.cuda.synchronize()
            # The graph's warm-up step drew first; it was undone, and the
            # first replay drew the same indices again.
            first = int(pos.item()) - CHUNK_STEPS
            runs[mode] = (rec[first:first + CHUNK_STEPS].clone(),
                          [getattr(runner.params, k).detach().clone()
                           for k in PARAM_KEYS])
            runner.close()
    finally:
        sb.sample_step_indices = sample

    def gap(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    idx_equal = all(torch.equal(runs[m][0], runs["plain"][0])
                    for m in ("plain_again", "graph"))
    plain_gap = gap(runs["plain"][1], runs["plain_again"][1])
    graph_gap = gap(runs["graph"][1], runs["plain"][1])
    out = {"steps": CHUNK_STEPS, "indices_bitwise_equal": idx_equal,
           "max_param_diff_graph_vs_plain": graph_gap,
           "max_param_diff_plain_vs_plain": plain_gap,
           "tol": 2.0 * plain_gap}
    for mode in ("plain", "graph"):
        runner = step_runner(torch, trainer, final, mask, t_cache,
                             graphs=mode == "graph")
        runner.run(1, CHUNK_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(CHUNK_STEPS + 1, CHUNK_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / CHUNK_STEPS
        before = {name: fn.launches for name, fn in kernel_counters().items()}
        prof = profile_calls(
            lambda i: runner.run(2 * CHUNK_STEPS + 1 + i, 1), 20)
        counts = {name: fn.launches - before[name]
                  for name, fn in kernel_counters().items()}
        runner.close()
        traced = {TRACE_NAMES[k]: n
                  for k, n in prof.pop("hand_kernel_events").items()}
        out[mode] = {"wall_ms_per_step": wall,
                     "device_busy_share":
                         prof["device_busy_ms_per_step"] / wall,
                     **prof, "launches_20_steps": counts,
                     "traced_20_steps": traced}
        if {k: n for k, n in counts.items() if n} != traced:
            raise AssertionError(f"{label} {mode}: launch counts {counts} "
                                 f"disagree with the trace's {traced}")
    emit(f"chunk_{label}", **out)
    if not idx_equal:
        raise AssertionError(f"{label}: the captured chunk drew other "
                             f"indices than the plain loop")
    if graph_gap > 2.0 * plain_gap:
        raise AssertionError(f"{label}: captured chunk {graph_gap:.3e} from "
                             f"the plain loop, two plain runs "
                             f"{plain_gap:.3e} apart")
    if out["graph"]["graph_launches_per_step"] < 1.0:
        raise AssertionError(f"{label}: the trace shows no graph launch")
    return out


def phase_generate_and_train(torch, tmp: str) -> dict:
    """generate + train (config 1) in ``tmp`` (the dataset stays in
    ``tmp``/data) → K1 and K2's launch counts on that path."""
    import numpy as np

    from burn_raymarching_tpu_torch.data.scene_io import load_cameras
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
    from burn_raymarching_tpu_torch.ops.cuda import shade_kernel as k2
    from burn_raymarching_tpu_torch.tools import generate, train_cli
    from burn_raymarching_tpu_torch.train.evaluate import evaluate_views
    from burn_raymarching_tpu_torch.data.image_io import load_image_as_array
    from burn_raymarching_tpu_torch.train.loop import Trainer

    counters = c1_counters()
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    generate.main(["--out", data, "--size", "256", "--device", "cuda"])
    emit("generate", views=10, size=256,
         seconds=round(time.perf_counter() - t0, 3))

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer, padded, mask = train_cli.main([
        "--cameras", os.path.join(data, "cameras.json"),
        "--stages", str(TRAIN_STAGES), "--steps", str(TRAIN_STEPS),
        "--scene-out", os.path.join(tmp, "scene.json"),
        "--steps-dir", os.path.join(tmp, "steps"),
        "--checkpoint-dir", os.path.join(tmp, "checkpoints"),
        "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    cfg = trainer.cfg
    n_final = int(mask.sum().item())
    final_loss = trainer.loss_history[-1]
    with open(os.path.join(tmp, "scene.json")) as f:
        scene = json.load(f)
    if scene["num_spheres"] != n_final:
        raise AssertionError("scene.json does not hold the final scene")
    cams = load_cameras(os.path.join(data, "cameras.json"))
    targets = [load_image_as_array(c["file"]) for c in cams]
    ev = evaluate_views(padded, cams, targets, cfg.width,
                        cfg.height, smooth_k=cfg.max_smooth_k, mask=mask,
                        march_normal_fn=trainer.march_normal_fn)
    rate_kernels = step_rate(torch, trainer, padded, mask)
    wall_ms = cfg.batch_size / rate_kernels * 1000.0
    prof = device_profile(torch, trainer, padded, mask, None, steps=20)
    plain_trainer = Trainer(dataclasses.replace(cfg, use_pallas=False),
                            trainer.dataset, log=lambda s: None)
    rate_plain = step_rate(torch, plain_trainer, padded, mask)
    emit("train", stages=TRAIN_STAGES, steps_per_stage=TRAIN_STEPS,
         batch=cfg.batch_size, seconds=round(train_s, 3),
         final_n=n_final, final_loss=final_loss,
         psnr_mean=ev["mean"], psnr_min=ev["min"],
         loss_history=trainer.loss_history,
         rays_per_s_kernels=rate_kernels,
         rays_per_s_kernels_one_step_at_a_time=step_rate(
             torch, trainer, padded, mask, graphs=False),
         rays_per_s_plain=rate_plain, wall_ms_per_step=wall_ms,
         device_busy_share=prof["device_busy_ms_per_step"] / wall_ms,
         **prof, launches=launches,
         all_finite=bool(np.isfinite(
             np.asarray(scene["centers"] + scene["radii"])).all()))
    if not (math.isfinite(final_loss) and ev["mean"] > MIN_PSNR_DB):
        raise AssertionError(f"bad training result: loss {final_loss}, "
                             f"PSNR {ev['mean']} (need > {MIN_PSNR_DB})")
    phase_chunk(torch, "c1", trainer, padded, mask)
    return launches


def c1_counters() -> dict:
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
    from burn_raymarching_tpu_torch.ops.cuda import shade_kernel as k2

    return {"march_shade": k1.march_shade,
            "march_pack": k1.pack_march_table,
            "shade_pack": k2.pack_shade_table,
            "shade_fwd": k2.launch_shade_fwd,
            "shade_bwd": k2.launch_shade_bwd}


def c4_argv(data: str, out: str, stages: int = TRAIN_STAGES,
            steps: int = TRAIN_STEPS) -> list:
    """tools/run_c5.py arguments of config 4 (runs/c4_r2: the flags that
    differ from run_c5's config-5 defaults), cut to ``stages`` x ``steps``,
    without the ceiling."""
    return ["--out", out, "--data", data, "--views", str(C4_VIEWS),
            "--size", str(C4_SIZE), "--gt-n", str(C4_GT_N),
            "--init-n", str(C4_INIT_N), "--cull-budget", str(C4_BUDGET),
            "--merge-cell", "0.04", "--stages", str(stages),
            "--steps", str(steps), "--skip-ceiling"]


def trainer_on_scene(torch, dev, argv: list, scene: str):
    """A Trainer of ``argv``'s configuration holding the scene a run
    exported, with its t cache prefilled → (trainer, padded, mask)."""
    from burn_raymarching_tpu_torch.tools import run_c5
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    args = run_c5.make_parser().parse_args(argv)
    cfg = run_c5.build_config(args, args.data)
    trainer = Trainer(cfg, build_dataset(cfg, device=dev),
                      log=lambda s: None)
    padded, mask = run_c5.scene_padded(scene, dev)
    trainer.prefill_t_cache(padded, mask, cfg.max_smooth_k)
    return trainer, padded, mask


def phase_c4(torch, dev, tmp: str) -> dict:
    """generate_c4 + train_c4 in ``tmp`` (the knot set stays in
    ``tmp``/data_c4, the trained scene in ``tmp``/scene_c5.json) → K3's,
    K4's, K6's and K7's launch counts on that path."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.ops.cuda import culled_shade_kernel as k6
    from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4
    from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7
    from burn_raymarching_tpu_torch.tools import generate, run_c5
    from burn_raymarching_tpu_torch.train.loop import Trainer

    counters = {"culled_march": k3.culled_march_normals,
                "culled_shade_fwd": k6.launch_ctail_fwd,
                "culled_shade_bwd": k6.launch_ctail_bwd,
                "repulsion_fwd": k4.launch_rep_fwd,
                "repulsion_bwd": k4.launch_rep_bwd,
                "tile_select": k7.launch_tile_select}
    data = os.path.join(tmp, "data_c4")
    t0 = time.perf_counter()
    generate.main(run_c5.generate_argv(data, views=C4_VIEWS,
                                       size=C4_SIZE, gt_n=C4_GT_N))
    emit("generate_c4", views=C4_VIEWS, size=C4_SIZE, gt_n=C4_GT_N,
         seconds=round(time.perf_counter() - t0, 3))

    # The main path: run_c5 with config 4's flags (its init and trained
    # PSNR passes included).
    argv = c4_argv(data, tmp)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_c5.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the config-4 "
                             f"path: {missing}")

    trainer, padded, mask = trainer_on_scene(
        torch, dev, argv, os.path.join(tmp, "scene_c5.json"))
    cfg = trainer.cfg
    final_loss = res["loss_history"][-1]
    rate_kernels = step_rate(torch, trainer, padded, mask,
                             t_cache=trainer.t_cache)
    wall_ms = cfg.batch_size / rate_kernels * 1000.0
    prof = device_profile(torch, trainer, padded, mask, trainer.t_cache)
    plain_trainer = Trainer(dataclasses.replace(cfg, use_pallas=False),
                            trainer.dataset, log=lambda s: None)
    rate_plain = step_rate(torch, plain_trainer, padded, mask, steps=10,
                           t_cache=trainer.t_cache)
    emit("train_c4", stages=TRAIN_STAGES, steps_per_stage=TRAIN_STEPS,
         batch=cfg.batch_size, init_n=C4_INIT_N,
         seconds=round(run_s, 3), train_seconds=res["train_wall_s"],
         final_n=res["n_final"], final_loss=final_loss,
         loss_history=res["loss_history"], psnr_init=res["init"],
         psnr_trained=res["trained"],
         eval_seconds_per_pass=round(res["eval_wall_s"], 3),
         rays_per_s_kernels=rate_kernels,
         rays_per_s_kernels_one_step_at_a_time=step_rate(
             torch, trainer, padded, mask, t_cache=trainer.t_cache,
             graphs=False),
         rays_per_s_plain=rate_plain,
         wall_ms_per_step=wall_ms,
         device_busy_share=prof["device_busy_ms_per_step"] / wall_ms,
         **prof,
         launches=launches)
    if not (math.isfinite(final_loss) and res["trained"] > res["init"]):
        raise AssertionError(f"bad config-4 result: loss {final_loss}, "
                             f"PSNR {res['trained']} (init {res['init']})")
    phase_chunk(torch, "c4", trainer, padded, mask, trainer.t_cache)

    # One boundary with residual-attribution splitting.
    t0 = time.perf_counter()
    res_r = run_c5.main(c4_argv(data, os.path.join(tmp, "residual"),
                                steps=30) + ["--split-mode", "residual"])
    boundary = events_of(res_r["events"], "density")
    if not boundary or boundary[0]["split"] <= 0:
        raise AssertionError("the residual split mode split nothing")
    emit("residual_split_c4", **boundary[0], final_n=res_r["n_final"],
         seconds=round(time.perf_counter() - t0, 3))
    return launches


def headline_argv(data: str, out: str) -> list:
    """tools/run_c5.py arguments of the JAX package's headline config-4
    recipe (runs/c4_headline/results.json: 5 stages, gaussian coverage,
    mask sharpness 40, sigmoid on the stacked first stage), with 100-step
    stages so that a polish round is 100 steps."""
    return c4_argv(data, out, stages=5) + [
        "--coverage", "gaussian", "--mask-sharp", "40",
        "--coverage-stages", "sigmoid,gaussian"]


def phase_refine_c4(torch, dev, tmp: str) -> tuple[dict, dict]:
    """The quality recipe on the knot set that phase_c4 left in ``tmp`` →
    (K3's, K4's and K7's launch counts on this path, K3's figures at the
    acceptance loss's shape)."""
    import numpy as np

    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.models.scene import activate
    from burn_raymarching_tpu_torch.tools import run_c5
    from burn_raymarching_tpu_torch.tools.device_time import profile_calls
    from burn_raymarching_tpu_torch.train import refine
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset
    from burn_raymarching_tpu_torch.train.residual import (
        primitive_residual_scores,
    )
    from burn_raymarching_tpu_torch.train.step_body import culled_tables

    from burn_raymarching_tpu_torch.data.scene_io import load_scene_json
    from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4
    from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7

    data = os.path.join(tmp, "data_c4")
    out = os.path.join(tmp, "refine")
    refine_flags = ["--refine-proposals", "64", "--refine-phases", "2",
                    "--refine-bias", "residual", "--refine-colors", "0.25",
                    "--refine-fringe", "4", "--refine-light", "8"]
    counters = {"culled_march": k3.culled_march_normals,
                "repulsion_fwd": k4.launch_rep_fwd,
                "repulsion_bwd": k4.launch_rep_bwd,
                "tile_select": k7.launch_tile_select}

    def gated_run(argv):
        """tools/run_c5.py with every count of this path set to 0 just
        before and read just after → (results, launches, seconds, peak)."""
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = run_c5.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return (results, {name: fn.launches for name, fn in counters.items()},
                round(seconds, 3), torch.cuda.max_memory_allocated())

    # The main path: the committed scene through --from-scene, one polish
    # round (K3 and K4 in its 100 training steps), one refine round (K3 in
    # the acceptance loss).
    results, launches, seconds, peak_main = gated_run(
        headline_argv(data, out) + ["--from-scene", HEADLINE_SCENE,
                                    "--polish", "1", "--refine", "1",
                                    *refine_flags])
    polish = events_of(results["events"], "polish")
    rounds = events_of(results["events"], "refine")
    if len(polish) != 1 or len(rounds) != 1:
        raise AssertionError("polish or refine round missing from the run")
    emit("refine_c4", scene="runs/c4_headline/scene_c5.json",
         psnr_recorded_by_jax_package=HEADLINE_PSNR_DB,
         psnr_from_scene=results["init"], psnr_after=results["trained"],
         polish=polish[0], refine=rounds[0], n_final=results["n_final"],
         seconds=seconds, peak_memory_bytes=peak_main, launches=launches)
    if abs(results["init"] - HEADLINE_PSNR_DB) > HEADLINE_TOL_DB:
        raise AssertionError(
            f"the committed scene reads {results['init']:.3f} dB, the JAX "
            f"package recorded {HEADLINE_PSNR_DB:.3f}")
    if not (math.isfinite(results["trained"])
            and results["trained"] >= results["init"]):
        raise AssertionError(f"the gated rounds returned a lower PSNR: "
                             f"{results['init']} -> {results['trained']}")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the polish and "
                             f"refine path: {missing}")

    # The accept path: the committed scene sits at an optimum of the coarse
    # proposal scales, so a cut round there accepts little or nothing. The
    # scene that phase_c4's 2 x 100 steps left is far from one: a refine
    # round at fine scales (1/4 and 1/8 of the defaults) must accept
    # proposals there, and a kept round must return other params and a
    # higher PSNR.
    trained_scene = os.path.join(tmp, "scene_c5.json")
    out_t = os.path.join(tmp, "refine_trained")
    res_t, launches_t, seconds_t, _ = gated_run(c4_argv(data, out_t) + [
        "--from-scene", trained_scene, "--refine", "1",
        "--refine-proposals", "64", "--refine-phases", "2",
        "--refine-sigma-c", "0.075", "--refine-sigma-r", "0.0375",
        "--refine-bias", "residual", "--refine-colors", "0.0625",
        "--refine-fringe", "4"])
    round_t = events_of(res_t["events"], "refine")[0]
    before = load_scene_json(trained_scene)
    after = load_scene_json(os.path.join(out_t, "scene_c5.json"))
    moved = float(np.abs(after["centers"] - before["centers"]).max())
    emit("refine_accept_c4", scene="the scene phase_c4 trained",
         psnr_from_scene=res_t["init"], psnr_after=res_t["trained"],
         refine=round_t, max_center_move=moved, seconds=seconds_t,
         launches=launches_t)
    if round_t["accepted"] <= 0 or launches_t["culled_march"] <= 0:
        raise AssertionError(f"the refine round accepted no proposal on a "
                             f"barely trained scene: {round_t}")
    # (A reverted round re-exports the loaded scene: its decode and encode
    # move a centre by float32 rounding only.)
    if round_t["kept"] != (moved > 1e-5) or round_t["kept"] != (
            res_t["trained"] > res_t["init"]):
        raise AssertionError(f"the gate and the returned scene disagree: "
                             f"{round_t}, centers moved {moved}, PSNR "
                             f"{res_t['init']} -> {res_t['trained']}")

    # Below: the same trainer configuration, driven piece by piece to read
    # where a proposal's time goes. None of it counts as a launch above.
    cfg = run_c5.build_config(
        run_c5.make_parser().parse_args(headline_argv(data, out)), data)
    trainer = Trainer(cfg, build_dataset(cfg, device=dev),
                      log=lambda s: None)
    padded, mask = run_c5.scene_padded(HEADLINE_SCENE, dev)
    kern = trainer.culled_march_normal_fn
    failures = []

    # Residual scores: two calls, bitwise equal.
    t0 = time.perf_counter()
    scores = primitive_residual_scores(padded, mask, trainer.dataset, cfg,
                                       cfg.max_smooth_k, kern=kern)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    again = primitive_residual_scores(padded, mask, trainer.dataset, cfg,
                                      cfg.max_smooth_k, kern=kern)
    if not (np.array_equal(scores, again) and np.isfinite(scores).all()
            and scores.max() > 0):
        failures.append("residual scores differ between two calls")
    emit("residual_scores", seconds=round(score_s, 3),
         bitwise_repeatable=bool(np.array_equal(scores, again)),
         nonzero=int((scores > 0).sum()), live=int(mask.sum().item()))

    # K3 at the acceptance loss's shape: 512 fg tiles, cold, tables from the
    # committed scene; against the plain version on a slice of the tiles.
    batches = refine.sample_fg_tile_batches(
        trainer.dataset, tiles=REFINE_TILES, seed=7919, tile=cfg.cull_tile)
    ro, rd, _ = batches[0]
    with torch.no_grad():
        c, _, r, _, _ = activate(padded)
        _, valid, cs, rs, qs = culled_tables(cfg, ro, rd, c, r, C4_K, mask)
    b = ro.shape[0] // cfg.cull_tile
    args = (ro.reshape(b, cfg.cull_tile, 3), rd.reshape(b, cfg.cull_tile, 3),
            cs, rs, qs)
    t_k, n_k = k3.culled_march_normals(*args, C4_K)
    torch.cuda.synchronize()
    pick = torch.arange(0, b, b // REFINE_CHECK_TILES,
                        device=dev)[:REFINE_CHECK_TILES]
    part = [a[pick].contiguous() for a in args]
    t_p, n_p = culled_march_normals_xla(*part, C4_K)
    t_64, n_64 = culled_march_normals_xla(*[a.double() for a in part], C4_K)
    errs = march_errors(torch, t_k[pick], n_k[pick], t_p, n_p)
    tols = march_noise_tols(torch, t_p, n_p, t_64, n_64)
    for key, tol in tols.items():
        check_close(failures, f"K3 refine shape {key}", errs[key], tol)
    valid_slots = int(valid.sum())
    shape = dict(
        refine_tiles=b, refine_valid_slots=valid_slots,
        refine_max_abs_err=errs["max_abs_err_t_hit"],
        refine_ms=time_ms(torch, lambda: k3.culled_march_normals(
            *args, C4_K), reps=10),
        refine_device_ms=graph_ms(torch, lambda: k3.culled_march_normals(
            *args, C4_K), launches=5),
        refine_plain_ms_on_slice=time_ms(
            torch, lambda: culled_march_normals_xla(*part, C4_K), reps=3),
        refine_bound_ms=march_bound(47.0 * cfg.cull_tile * valid_slots,
                                    *args, t_k, n_k)["bound_ms"])
    emit("kernel", name="culled_march_refine_shape", checked_tiles=len(pick),
         errs=errs, tol=tols, **shape)

    # One proposal = the acceptance loss on both batches. Wall time from 8
    # proposals of the greedy chain, then the same under the profiler.
    def chain(n):
        return refine.geometry_refine(
            padded, mask, batches, cfg, kern=kern, proposals=n, phases=1,
            sigma_col=0.25, fringe_weight=4.0, select_probs=scores, chunk=n,
            generator=torch.Generator(device=dev).manual_seed(0),
            log=lambda s: None)

    chain(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_prop = 8
    t0 = time.perf_counter()
    _, stats = chain(n_prop)
    torch.cuda.synchronize()
    # The chain also evaluates the starting point once on each batch.
    wall_ms = (time.perf_counter() - t0) * 1000.0 / (n_prop + 1)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_calls(lambda i: chain(n_prop), 1)
    per = {key: (prof[key] / (n_prop + 1)) for key in (
        "device_busy_ms_per_step", "device_events_per_step")}
    k3_ms = prof["hand_kernels_ms_per_step"].get("culled_march_kernel",
                                                 0.0) / (n_prop + 1)
    emit("refine_proposal", tiles_per_batch=b, batches=2,
         wall_ms_per_proposal=wall_ms,
         device_busy_ms_per_proposal=per["device_busy_ms_per_step"],
         device_busy_share=per["device_busy_ms_per_step"] / wall_ms,
         device_events_per_proposal=per["device_events_per_step"],
         k3_ms_per_proposal=k3_ms,
         k3_share_of_busy=k3_ms / per["device_busy_ms_per_step"],
         top_kernels_ms_per_proposal=[[name, d / (n_prop + 1)] for name, d
                                      in prof["top_kernels_ms_per_step"]],
         peak_memory_bytes=peak, loss_before=stats.loss_before,
         loss_after=stats.loss_after, accepted=stats.accepted)
    if not (math.isfinite(stats.loss_before)
            and math.isfinite(stats.loss_after)):
        failures.append("the acceptance loss is not finite")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, shape


def phase_guard_c1(torch, tmp: str) -> dict:
    """Config 1 with the stage guard, a supersampled first stage and one
    polish round, on the dango set that phase 5 left in ``tmp`` → K1 and
    K2's launch counts on this path."""
    from burn_raymarching_tpu_torch.tools import train_cli

    counters = c1_counters()
    for fn in counters.values():
        fn.launches = 0
    out = os.path.join(tmp, "guard")
    pixel_angle = 2.0 * math.tan(math.radians(50.0 / 2)) / 256
    t0 = time.perf_counter()
    trainer, padded, mask = train_cli.main([
        "--cameras", os.path.join(tmp, "data", "cameras.json"),
        "--stages", str(TRAIN_STAGES), "--steps", str(TRAIN_STEPS),
        "--scene-out", os.path.join(out, "scene.json"),
        "--steps-dir", os.path.join(out, "steps"), "--checkpoint-dir", "",
        "--stage-guard", "--ss-stages", "4,1",
        "--pixel-angle", repr(pixel_angle), "--polish", "1",
        "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    guard = events_of(trainer.events, "guard")
    polish = events_of(trainer.events, "polish")
    psnr = trainer.views_psnr(padded, mask)
    emit("guard_c1", stages=TRAIN_STAGES, steps_per_stage=TRAIN_STEPS,
         supersample_stages=list(trainer.cfg.supersample_stages),
         seconds=round(seconds, 3), guard=guard,
         guard_retries=trainer.guard_retry_count,
         guard_boundary_redos=trainer.guard_boundary_redo_count,
         polish=polish, psnr_final=psnr, final_n=int(mask.sum().item()),
         loss_history=trainer.loss_history, launches=launches)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the guarded path: "
                             f"{missing}")
    if not (len(polish) == 1 and len(guard) >= TRAIN_STAGES
            and math.isfinite(psnr)
            and all(math.isfinite(e["psnr_post"]) for e in guard)
            and all(math.isfinite(x) for x in trainer.loss_history)
            and psnr >= polish[0]["baseline"]):
        raise AssertionError(f"bad guarded run: PSNR {psnr}, guard {guard}, "
                             f"polish {polish}")
    return launches


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by the ``kernels`` line's
    names."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.ops.cuda import culled_shade_kernel as k6
    from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4

    from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7

    return {**c1_counters(), "culled_march": k3.culled_march_normals,
            "culled_shade_fwd": k6.launch_ctail_fwd,
            "culled_shade_bwd": k6.launch_ctail_bwd,
            "repulsion_fwd": k4.launch_rep_fwd,
            "repulsion_bwd": k4.launch_rep_bwd,
            "tile_select": k7.launch_tile_select}


def counted(torch, run, counters: dict | None = None) -> tuple:
    """``run()`` with every kernel's count (of ``counters``, by default the
    training kernels') set to 0 just before and read just after → (its
    result, launches per kernel, seconds)."""
    counters = counters or kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (out, {name: fn.launches for name, fn in counters.items()},
            round(time.perf_counter() - t0, 3))


def require_launches(launches: dict, names, path: str) -> None:
    missing = [name for name in names if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


def k3_case(torch, args, k, steps, t_init, label, failures) -> dict:
    """K3 at one shape against its plain version, held to 5x the plain
    version's own gap to the float64 march (march_noise_tols) → errors,
    times and the bound of the work this run's tables need."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )

    kw = dict(num_steps=steps, t_init=t_init)
    t_k, n_k = k3.culled_march_normals(*args, k, **kw)
    t_p, n_p = culled_march_normals_xla(*args, k, **kw)
    t_64, n_64 = culled_march_normals_xla(
        *[a.double() for a in args], k, num_steps=steps,
        t_init=None if t_init is None else t_init.double())
    errs = march_errors(torch, t_k, n_k, t_p, n_p)
    tols = march_noise_tols(torch, t_p, n_p, t_64, n_64)
    for key, tol in tols.items():
        check_close(failures, f"K3 {label} {key}", errs[key], tol)
    tiles, rays = args[0].shape[0], args[0].shape[1]
    valid_slots = int((args[4] < 1e29).sum())
    return dict(
        tiles=tiles, rays_per_tile=rays, table=args[2].shape[1],
        valid_slots=valid_slots, num_steps=steps, errs=errs, tol=tols,
        max_abs_err=errs["max_abs_err_t_hit"],
        ms=time_ms(torch, lambda: k3.culled_march_normals(*args, k, **kw)),
        device_ms=graph_ms(torch, lambda: k3.culled_march_normals(
            *args, k, **kw), launches=5),
        plain_ms=time_ms(torch, lambda: culled_march_normals_xla(
            *args, k, **kw), reps=3),
        **march_bound((steps + 7.0) * rays * valid_slots, *args, t_init,
                      t_k, n_k))


def phase_c5(torch, dev, tmp: str) -> tuple[dict, dict]:
    """Config 5 cut to the script's time → (the launches of its training
    path, K3's figures at config 5's shape)."""
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.tools import generate, run_c5

    data = os.path.join(tmp, "data_c5")
    t0 = time.perf_counter()
    generate.main(run_c5.generate_argv(data))
    emit("generate_c5", views=C5_VIEWS, size=C5_SIZE, gt_n=C5_GT_N,
         seconds=round(time.perf_counter() - t0, 3))
    # The training cut: the first C5_TRAIN_VIEWS cameras of the set.
    sub = os.path.join(tmp, "data_c5_cut")
    os.makedirs(sub)
    with open(os.path.join(data, "cameras.json")) as f:
        cams = json.load(f)[:C5_TRAIN_VIEWS]
    for cam in cams:
        cam["file"] = os.path.join(data, os.path.basename(cam["file"]))
    with open(os.path.join(sub, "cameras.json"), "w") as f:
        json.dump(cams, f)
    with open(os.path.join(data, "points.json")) as f_in, open(
            os.path.join(sub, "points.json"), "w") as f_out:
        f_out.write(f_in.read())
    out = os.path.join(tmp, "c5")
    argv = ["--out", out, "--data", sub, "--views", str(C5_TRAIN_VIEWS),
            "--stages", "2", "--steps", str(C5_STEPS), "--device", "cuda"]
    res, launches, seconds = counted(torch, lambda: run_c5.main(argv))
    emit("train_c5", views=C5_TRAIN_VIEWS, size=C5_SIZE, init_n=C5_INIT_N,
         cull_budget=C5_BUDGET, stages=2, steps_per_stage=C5_STEPS,
         ceiling=res["ceiling"], init=res["init"], trained=res["trained"],
         n_final=res["n_final"], loss_history=res["loss_history"],
         eval_wall_s=res["eval_wall_s"], train_wall_s=res["train_wall_s"],
         events=res["events"], seconds=seconds, launches=launches)
    require_launches(launches, ("march_shade", "culled_march",
                                "repulsion_fwd", "repulsion_bwd"), "config-5")
    if not (all(math.isfinite(x) for x in res["loss_history"])
            and res["trained"] > res["init"]):
        raise AssertionError(f"bad config-5 result: {res['init']} -> "
                             f"{res['trained']}, losses "
                             f"{res['loss_history']}")

    # The step at config 5's width on the scene it trained: wall and
    # device-busy time, the top device ops.
    trainer, padded, mask = trainer_on_scene(
        torch, dev, argv, os.path.join(out, "scene_c5.json"))
    cfg = trainer.cfg
    steps = {}
    for graphs in (True, False):
        rate = step_rate(torch, trainer, padded, mask, steps=20,
                         t_cache=trainer.t_cache, graphs=graphs)
        wall_ms = cfg.batch_size / rate * 1000.0
        prof = device_profile(torch, trainer, padded, mask, trainer.t_cache,
                              graphs=graphs)
        prof.pop("hand_kernel_events")
        steps["graph" if graphs else "plain"] = dict(
            rays_per_s_kernels=rate, wall_ms_per_step=wall_ms,
            device_busy_share=prof["device_busy_ms_per_step"] / wall_ms,
            **prof)
    emit("step_c5", n_live=int(mask.sum()), slots=padded.n, **steps,
         peak_memory_bytes=torch.cuda.max_memory_allocated())

    # K3 at config 5's shape: 32 tiles of the 256² rig against per-tile
    # top-4,096 tables of the 51,200-sphere prior cloud, cold and warm.
    failures = []
    _, c_mask, c, r = knot_cloud(torch, dev, C5_INIT_N, gt_n=C5_GT_N)
    args, stats = c4_tiles(torch, dev, c, r, c_mask, size=C5_SIZE,
                           views=C5_VIEWS, budget=C5_BUDGET)
    cold = k3_case(torch, args, C4_K, 40, None, "config-5 cold", failures)
    t_warm = (culled_march_normals_xla(*args, C4_K)[0] * 0.8).contiguous()
    warm = k3_case(torch, args, C4_K, 16, t_warm, "config-5 warm", failures)
    emit("kernel", name="culled_march_c5", **stats, cold=cold, warm16=warm)

    # The committed config-5 scene through --from-scene on the 100 views.
    res_s, _, seconds_s = counted(torch, lambda: run_c5.main([
        "--out", os.path.join(tmp, "c5_read"), "--data", data,
        "--cull-budget", str(C5_BUDGET), "--coverage", "gaussian",
        "--mask-sharp", "40", "--skip-ceiling", "--from-scene", C5_SCENE,
        "--device", "cuda"]))
    emit("from_scene_c5", scene="runs/c5_stack3/scene_c5.json",
         psnr=res_s["init"], psnr_recorded_by_jax_package=C5_SCENE_PSNR_DB,
         seconds=seconds_s)
    check_close(failures, "runs/c5_stack3 scene PSNR (dB)",
                abs(res_s["init"] - C5_SCENE_PSNR_DB), HEADLINE_TOL_DB)
    if failures:
        raise AssertionError("; ".join(failures))
    shape = {f"c5_{key}": warm[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
        "valid_slots")}
    shape["c5_table"] = C5_BUDGET
    shape["c5_cold_device_ms"] = cold["device_ms"]
    shape["c5_cold_bound_ms"] = cold["bound_ms"]
    return launches, shape


def u8_gaps(a, b) -> dict:
    """Two frames as the viewer writes them (gamma 2.2, uint8) → mean
    |du8|, the share of pixels more than 2 LSB off, and the share where
    one is lit and the other black."""
    import numpy as np

    def u8(img):
        img = np.clip(np.asarray(img), 0, 1)
        return (img ** (1 / 2.2) * 255).astype(np.int32).reshape(-1, 3)

    ua, ub = u8(a), u8(b)
    diff = np.abs(ua - ub)
    return {"mean_lsb": float(diff.mean()),
            "share_over_2_lsb": float((diff > 2).mean()),
            "lit_mismatch_share": float(
                ((ua.sum(1) > 0) != (ub.sum(1) > 0)).mean())}


def check_u8(failures: list, name: str, gaps: dict) -> None:
    check_close(failures, f"{name} mean |du8|", gaps["mean_lsb"],
                VIEWER_MEAN_LSB)
    check_close(failures, f"{name} share of pixels > 2 LSB off",
                gaps["share_over_2_lsb"], VIEWER_OFF2_SHARE)
    check_close(failures, f"{name} share of pixels lit in one frame only",
                gaps["lit_mismatch_share"], VIEWER_LIT_MISMATCH)


def wall_ms(torch, fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` (which ends in a host copy or a
    synchronisation) over ``reps`` calls, in ms; the phase has run the same
    kernels before."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1000.0 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_viewer(torch, dev, tmp: str) -> tuple[dict, dict]:
    """The offline and HTTP viewers on runs/c5_headline/scene_c5.json →
    (the launches of the viewer's main path, K1's figures at its shape).

    (a) ``render_pose(model="train")`` at 512², K1 counted: its frame held
    to the same frame through the plain march, frame ms, device-busy and K1
    ms per frame against K1's bound; (b) ``model="viewer"`` (plain PyTorch)
    frame ms, and its float32 frame at 128² against a float64 run; frame ms
    of both models at 96², 384² and 512²; (c) the HTTP viewer in a thread:
    its page, /scene and low and full frames of both models; (d) one frame
    under utils.profiling.trace inside annotate("viewer_frame")."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.data.image_io import read_png
    from burn_raymarching_tpu_torch.data.scene_io import load_scene_json
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
    from burn_raymarching_tpu_torch.tools import device_time
    from burn_raymarching_tpu_torch.tools import viewer_offline as view
    from burn_raymarching_tpu_torch.tools.viewer_server import (
        _ViewerState,
        make_handler,
    )
    from burn_raymarching_tpu_torch.utils import profiling

    scene = load_scene_json(VIEWER_SCENE)
    m = scene["num_spheres"]
    params = view.scene_tensors(scene, dev)
    failures = []
    torch.cuda.reset_peak_memory_stats()

    def frame(model: str, size: int = VIEWER_SIZE):
        return view.render_pose(scene, VIEWER_EYE, [0.0, 0.0, 0.0], size,
                                model=model, device=dev)

    # (a) The main path: train-model frames through K1, counted.
    pixels = VIEWER_SIZE * VIEWER_SIZE
    per_frame = math.ceil(pixels / VIEWER_CHUNK)
    n_frames = 3
    imgs, launches, seconds = counted(
        torch, lambda: [frame("train") for _ in range(n_frames)])
    want = {name: 0 for name in launches}
    want["march_shade"] = want["march_pack"] = n_frames * per_frame
    if launches != want:
        raise AssertionError(f"viewer launches {launches}, expected {want}")
    ro, rd = create_camera_rays(VIEWER_SIZE, VIEWER_SIZE, VIEWER_EYE,
                                [0.0, 0.0, 0.0], 50.0, device=dev)
    t0 = time.perf_counter()
    plain = view.train_shade(ro, rd, *params, chunk=VIEWER_CHUNK,
                             march_normal_fn=None).cpu().numpy()
    plain_frame_ms = 1000.0 * (time.perf_counter() - t0)
    gaps_train = u8_gaps(imgs[0], plain)
    check_u8(failures, "train-model frame, K1 vs plain march", gaps_train)
    prof = device_time.profile_calls(lambda s: frame("train"), 3)
    k1_dev = prof["hand_kernels_ms_per_step"].get("march_shade_kernel", 0.0)
    k1_frame = march_bound(
        (40.0 + 7.0) * pixels * m, ro, rd, params[0], params[2],
        torch.empty((pixels, 4), device=dev))
    # K1 on the chunk of the frame with the most lit pixels: against its
    # plain version (the larger of the fixed tolerances and 5x the plain
    # version's own gap to float64), timed.
    c, r = params[0], params[2]
    lit = (imgs[0].sum(1) > 0).reshape(per_frame, -1).sum(1)
    i0 = int(lit.argmax()) * VIEWER_CHUNK
    args = (ro[i0:i0 + VIEWER_CHUNK], rd[i0:i0 + VIEWER_CHUNK], c, r,
            view.VIEW_K)
    t_k, n_k = k1.march_shade(*args)
    t_p, n_p = k1.march_shade_plain(*args)
    t_64, n_64 = k1.march_shade_plain(*(a.double() for a in args[:4]),
                                      view.VIEW_K)
    errs = march_errors(torch, t_k, n_k, t_p, n_p)
    noise = march_noise_tols(torch, t_p, n_p, t_64, n_64)
    tols = {key: max(tol, noise[key]) for key, tol in MARCH_TOLS.items()}
    for key, tol in tols.items():
        check_close(failures, f"K1 viewer chunk {key}", errs[key], tol)
    chunk = dict(
        first_ray=i0, max_abs_err=errs["max_abs_err_t_hit"], tol=tols,
        errs=errs,
        ms=time_ms(torch, lambda: k1.march_shade(*args)),
        device_ms=graph_ms(torch, lambda: k1.march_shade(*args), launches=5),
        plain_ms=time_ms(torch, lambda: k1.march_shade_plain(*args),
                         reps=3),
        **march_bound(47.0 * VIEWER_CHUNK * m, *args[:4], t_k, n_k))
    emit("viewer_train", scene=os.path.relpath(VIEWER_SCENE, ROOT), spheres=m,
         size=VIEWER_SIZE, chunk=VIEWER_CHUNK, frames=n_frames,
         launches=launches, seconds=seconds, vs_plain_march=gaps_train,
         lit_share=float((imgs[0].sum(1) > 0).mean()),
         frame_ms=wall_ms(torch, lambda: frame("train"), 3),
         plain_march_frame_ms=plain_frame_ms,
         device_busy_ms_per_frame=prof["device_busy_ms_per_step"],
         device_events_per_frame=prof["device_events_per_step"],
         top_kernels_ms_per_frame=prof["top_kernels_ms_per_step"],
         k1_device_ms_per_frame=k1_dev,
         k1_bound_ms_per_frame=k1_frame["bound_ms"],
         k1_bound_by=k1_frame["bound_by"],
         k1_share_of_bound=k1_frame["bound_ms"] / k1_dev if k1_dev else 0.0,
         k1_chunk=chunk)
    if k1_dev <= 0.0:
        raise AssertionError("no march_shade_kernel time in the viewer trace")

    # (b) The viewer model (plain PyTorch), float32 against float64 at 128²;
    # frame times of both models.
    ro_s, rd_s = create_camera_rays(128, 128, VIEWER_EYE, [0.0, 0.0, 0.0],
                                    50.0, device=dev)
    f32 = view._viewer_shade(ro_s, rd_s, *params).cpu().numpy()
    f64 = view._viewer_shade(ro_s.double(), rd_s.double(),
                             *(p.double() for p in params)).cpu().numpy()
    gaps_64 = u8_gaps(f32, f64)
    check_u8(failures, "viewer-model frame, float32 vs float64", gaps_64)
    frame_ms = {model: {size: wall_ms(torch, lambda: frame(model, size),
                                      2 if model == "viewer" else 3)
                        for size in (96, SERVER_SIZE, VIEWER_SIZE)}
                for model in ("train", "viewer")}
    emit("viewer_viewer", size_float64_check=128, vs_float64=gaps_64,
         lit_share=float((f32.sum(1) > 0).mean()), frame_ms=frame_ms,
         peak_memory_gb_in_phase=torch.cuda.max_memory_allocated() / 1e9)

    # (c) The HTTP viewer, one server per model on a free localhost port.
    served = {}
    for model in ("viewer", "train"):
        state = _ViewerState(VIEWER_SCENE, SERVER_SIZE, model, device=dev)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_port}"
        try:
            page = urllib.request.urlopen(base + "/", timeout=60).read()
            info = json.loads(urllib.request.urlopen(base + "/scene",
                                                     timeout=60).read())
            got = {}
            for q, path, reps in (("low", "/frame?q=low", 4),
                                  ("full", "/frame", 3 if model == "train"
                                   else 2)):
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    png = urllib.request.urlopen(base + path,
                                                 timeout=300).read()
                    times.append(1000.0 * (time.perf_counter() - t0))
                png_path = os.path.join(tmp, f"viewer_{model}_{q}.png")
                with open(png_path, "wb") as f:
                    f.write(png)
                img = read_png(png_path)
                got[q] = {"shape": list(img.shape),
                          "lit_share": float((img.sum(2) > 0).mean()),
                          "median_ms": statistics.median(times[1:]),
                          "first_ms": times[0]}
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("the viewer server thread did not stop")
        if b"ArrowLeft" not in page or info["num_spheres"] != m:
            raise AssertionError(f"viewer server ({model}): bad page or "
                                 f"/scene {info}")
        for q, size in (("low", state.low_size), ("full", SERVER_SIZE)):
            if got[q]["shape"] != [size, size, 3]:
                raise AssertionError(f"{model} {q} frame {got[q]['shape']}")
            if got[q]["lit_share"] <= 0.1:
                raise AssertionError(f"{model} {q} frame lit share "
                                     f"{got[q]['lit_share']}")
        served[model] = got
    emit("viewer_server", size=SERVER_SIZE, frames=served)

    # (d) One frame under the profiler, annotated.
    trace_dir = os.path.join(tmp, "viewer_trace")
    with profiling.trace(trace_dir):
        with profiling.annotate("viewer_frame"):
            frame("train")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    found = {"viewer_frame": sum(e.get("name") == "prog.viewer_frame"
                                 for e in events),
             "march_shade_kernel": sum(
                 e.get("cat") == "kernel"
                 and "march_shade_kernel" in e.get("name", "")
                 for e in events)}
    emit("viewer_trace", events=len(events), found=found)
    if found["viewer_frame"] < 1 or found["march_shade_kernel"] != per_frame:
        raise AssertionError(f"the viewer trace holds {found}")
    if failures:
        raise AssertionError("; ".join(failures))
    shape = {f"viewer_{key}": chunk[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms")}
    shape.update(viewer_chunk_rays=VIEWER_CHUNK, viewer_slots=m,
                 viewer_frame_device_ms=k1_dev,
                 viewer_frame_bound_ms=k1_frame["bound_ms"],
                 viewer_launches_per_frame=per_frame)
    return launches, shape


def dist_rank(rank: int, world: int, port: int, path: str,
              device: str = "cuda:0") -> None:
    """One rank of the 2-rank model-axis march (spawned, gloo, both ranks on
    the one card): this rank's half of the Morton-sorted rows, its per-tile
    top-K tables, the union-table march through K3 (cold, then warm from
    0.8 of the cold t) and the plain march that combines the shards at
    every step → <path>.rank<r>.pt."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    import burn_raymarching_tpu_torch  # noqa: F401  (sets TF32 off)
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.parallel.collectives import Axis
    from burn_raymarching_tpu_torch.parallel.mesh import init_distributed
    from burn_raymarching_tpu_torch.parallel.train_step import replays_graphs
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.train.step_body import (
        culled_tables,
        sharded_culled_kernel_march,
    )

    init_distributed(device, backend="gloo",
                     init_method=f"tcp://localhost:{port}",
                     world_size=world, rank=rank, timeout_s=300)
    try:
        inp = torch.load(path, map_location=device)
        ax = Axis(group=dist.group.WORLD, size=world, index=rank)
        rows = inp["c"].shape[0] // world
        own = slice(rank * rows, (rank + 1) * rows)
        cfg = TrainConfig(cull_tile=C4_TILE, cull_budget=int(inp["budget"]))
        ro3, rd3 = inp["ro3"], inp["rd3"]
        _, _, cs, rs, qs = culled_tables(
            cfg, ro3.reshape(-1, 3), rd3.reshape(-1, 3), inp["c"][own],
            inp["r"][own], C4_K, inp["mask"][own])
        march = dict(normal_eps=1e-4)
        k3.culled_march_normals.launches = 0
        t_c, n_c = sharded_culled_kernel_march(
            k3.culled_march_normals, ax, ro3, rd3, cs, rs, qs, C4_K,
            num_steps=40, **march)
        t0 = (t_c * 0.8).contiguous()
        t_w, n_w = sharded_culled_kernel_march(
            k3.culled_march_normals, ax, ro3, rd3, cs, rs, qs, C4_K,
            num_steps=16, t_init=t0, **march)
        launches = k3.culled_march_normals.launches
        t_s, n_s = culled_march_normals_xla(ro3, rd3, cs, rs, qs, C4_K,
                                            model_axis=ax)
        torch.save({"t_cold": t_c.cpu(), "n_cold": n_c.cpu(),
                    "t_warm": t_w.cpu(), "n_warm": n_w.cpu(),
                    "t_sharded_plain": t_s.cpu(),
                    "n_sharded_plain": n_s.cpu(),
                    "tables": [x.cpu() for x in (cs, rs, qs)],
                    "launches": launches,
                    "graphs": replays_graphs(ro3.device, [ax])},
                   f"{path}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def two_card(torch, tmp: str, failures: list) -> None:
    """tests/test_torch_sharded_chunk.py's two-card case (its ranks from
    tests/torch_dist.py) on cards 0 and 1:
    the config-4 cut through DistributedTrainer at 1 x 2 and 2 x 1 over
    NCCL, captured against the same trainer one step at a time, bitwise on
    both ranks."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dist

    from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS

    for data, model in ((1, 2), (2, 1)):
        t0 = time.perf_counter()
        out = os.path.join(tmp, f"nccl_{data}x{model}")
        res = torch_dist.run_ranks(
            out, 2, torch_dist.graphs_vs_eager, data, model,
            dict(torch_dist.C4_CUT, use_pallas=True),
            torch_dist.morton_rays(), out,
            backend="nccl")
        gap = max(float(abs(r["graphs"]["params"][k]
                            - r["eager"]["params"][k]).max())
                  for r in res for k in PARAM_KEYS)
        modes = [[r[m]["events"][0]["graphs"] for m in ("graphs", "eager")]
                 for r in res]
        emit("distributed_nccl_2card", ran=True, mesh=[data, model],
             modes=modes, max_param_err_graphs_vs_eager=gap, tol=0.0,
             k3_launches=[r["graphs"]["k3_launches"] for r in res],
             seconds=round(time.perf_counter() - t0, 3))
        check_close(failures, f"2-card NCCL {data}x{model} captured vs one "
                    f"step at a time", gap, 0.0)
        if modes != [[True, False]] * 2:
            failures.append(f"2-card NCCL {data}x{model} modes {modes}")


def phase_distributed(torch, dev, tmp: str) -> tuple[dict, dict]:
    """DistributedTrainer and the sharded step on the card → (the launches
    of its paths, K3's figures at the union shape)."""
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from burn_raymarching_tpu_torch.models.scene import (
        PARAM_KEYS,
        SceneParams,
    )
    from burn_raymarching_tpu_torch.ops.culling import morton_order
    from burn_raymarching_tpu_torch.parallel.distributed import (
        DistributedTrainer,
    )
    from burn_raymarching_tpu_torch.parallel.mesh import (
        free_port,
        init_distributed,
    )
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.tools import run_c5, train_cli
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    failures = []

    def table_rows(p, n):
        """The first ``n`` rows (centers, colors, radii): the live ones of a
        run without density control."""
        return np.concatenate([getattr(p, k).detach().cpu().numpy()[:n]
                               for k in PARAM_KEYS[:3]], axis=1)

    class EagerDistributed(DistributedTrainer):
        """The same trainer forced to one step at a time."""

        def _replays_graphs(self):
            return False

    def graphs_event(trainer) -> dict:
        (ev,) = events_of(trainer.events, "graphs")
        return ev

    def sharded_run(trainer) -> tuple:
        """``trainer.run()`` counted (``counted``) → (params, mask,
        launches, seconds, device memory in GB: allocated at the start, the
        peak during the run)."""
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() / 1e9
        (p, m), launches, seconds = counted(torch, trainer.run)
        return p, m, launches, seconds, {
            "allocated_at_start_gb": start,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    def max_gap(a, b) -> float:
        return max(float((getattr(a, k) - getattr(b, k)).abs().max())
                   for k in PARAM_KEYS)

    def modes(label, trainer, plain_trainer, p, m, t_cache=None) -> dict:
        """phase_chunk on the sharded trainer's step, captured beside one
        step at a time, with wall, busy and host launch calls per step of
        both (the captured step must take at most 3 host launch calls); and
        on the plain Trainer's step from the same state (K4 with the frozen
        prep where the sharded step computes the plain repulsion and its
        prep), for a comparison in one call."""
        out = {"sharded": phase_chunk(torch, label, trainer, p, m, t_cache),
               "plain_trainer": phase_chunk(torch, f"{label}_plain_trainer",
                                            plain_trainer, p, m, t_cache)}
        calls = out["sharded"]["graph"]["host_launches_per_step"]
        if calls > 3:
            failures.append(f"{label}: {calls} host launch calls a "
                            f"captured step (at most 3)")
        return {who: {mode: {key: o[mode][key] for key in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_events_per_step", "host_launches_per_step",
            "graph_launches_per_step")} for mode in ("graph", "plain")}
            for who, o in out.items()}

    # (a) A 1 x 1 mesh over NCCL (a world of one on a free localhost port):
    # the sharded steps replay captured graphs (the trainer's "graphs"
    # event), and are held bitwise against the same trainer one step at a
    # time in this call and against the plain Trainer.
    init_distributed(dev)
    try:
        argv = c4_argv(os.path.join(tmp, "data_c4"),
                       os.path.join(tmp, "dist_c4"), stages=1,
                       steps=DIST_STEPS)
        cfg = run_c5.build_config(run_c5.make_parser().parse_args(argv),
                                  os.path.join(tmp, "data_c4"))
        ds = build_dataset(cfg, device=dev)
        dist_trainer = DistributedTrainer(cfg, ds, data=1, model=1,
                                          log=lambda s: None)
        p_d, m_d, launches_c4, seconds, memory_c4 = sharded_run(dist_trainer)
        eager_trainer = EagerDistributed(cfg, ds, data=1, model=1,
                                         log=lambda s: None)
        p_e, _, _, seconds_eager, _ = sharded_run(eager_trainer)
        ran = [graphs_event(dist_trainer), graphs_event(eager_trainer)]
        if [ev["graphs"] for ev in ran] != [True, False]:
            raise AssertionError(f"1x1 NCCL modes {ran}: the captured run "
                                 f"must replay graphs, the eager one not")
        err_eager = max_gap(p_d, p_e)
        # The sharded trainer Morton-sorts its rows at stage start; the plain
        # Trainer keeps them as they come. Two references, neither running
        # the sharded trainer's hook: (1) the plain Trainer on the init
        # sorted here by the Morton order of its centers, which must match
        # bitwise; (2) the plain Trainer in its own order, its row order[i]
        # paired with the sharded run's row i, held to the JAX package's
        # tolerance (tests/test_distributed.py:95-100: rows atol 4e-3 +
        # rtol 2e-2, light and ambient atol 4e-4). Where a tile's
        # candidates overflow the budget, top-K keeps the first of equal
        # scores by row, so another row order may keep other primitives;
        # on this cut the two runs stay inside the tolerance. (Sorting
        # both tables lexically, as the CPU test at 12 rows does, pairs
        # wrong rows at 5,120.)
        init = dist_trainer._init_params()
        n = init.n
        order = morton_order(init.centers.detach().cpu().numpy())
        idx = torch.as_tensor(order, device=dev)

        class SortedInit(Trainer):
            def _init_params(self):
                p = super()._init_params()
                return SceneParams(*(getattr(p, k).detach()[idx]
                                     for k in PARAM_KEYS[:3]),
                                   p.light_dir.detach(), p.ambient.detach())

        sorted_trainer = SortedInit(cfg, ds, log=lambda s: None)
        p_s, m_s = sorted_trainer.run()
        p_t, m_t = Trainer(cfg, ds, log=lambda s: None).run()
        if not int(m_d.sum()) == int(m_s.sum()) == int(m_t.sum()) == n:
            raise AssertionError(f"live rows {int(m_d.sum())} (sharded), "
                                 f"{int(m_s.sum())} / {int(m_t.sum())} "
                                 f"(plain), {n} (init)")
        err_sorted = max_gap(p_d, p_s)
        rows_d, rows_t = table_rows(p_d, n), table_rows(p_t, n)[order]
        excess = float(np.max(np.abs(rows_d - rows_t)
                              - (4e-3 + 2e-2 * np.abs(rows_t))))
        err_light = max(float((getattr(p_d, k) - getattr(p_t, k))
                              .abs().max()) for k in ("light_dir", "ambient"))
        emit("distributed_c4", mesh=[1, 1], backend=dist.get_backend(),
             stages=1, steps=DIST_STEPS, n_live=n, modes=ran,
             max_param_err_vs_eager_sharded_run=err_eager,
             max_param_err_vs_sorted_init_trainer=err_sorted, tol=0.0,
             own_order=dict(
                 max_row_err=float(np.abs(rows_d - rows_t).max()),
                 row_tol="atol 4e-3 + rtol 2e-2",
                 row_excess_over_tol=excess,
                 rows_outside_tol=int(np.sum(np.any(
                     np.abs(rows_d - rows_t)
                     > 4e-3 + 2e-2 * np.abs(rows_t), axis=1))),
                 max_light_ambient_err=err_light, light_ambient_tol=4e-4),
             seconds=seconds, seconds_eager=seconds_eager,
             memory=memory_c4, launches=launches_c4)
        check_close(failures, "1x1 captured DistributedTrainer vs the same "
                    "run one step at a time", err_eager, 0.0)
        check_close(failures, "1x1 DistributedTrainer vs the Trainer on the "
                    "Morton-sorted init", err_sorted, 0.0)
        check_close(failures, "1x1 DistributedTrainer rows vs the Trainer "
                    "in its own order (excess over atol 4e-3 + rtol 2e-2)",
                    excess, 0.0)
        check_close(failures, "1x1 DistributedTrainer light/ambient vs the "
                    "Trainer in its own order", err_light, 4e-4)
        require_launches(launches_c4, ("culled_march",), "1x1 culled")
        step_c4 = modes("dist_c4", dist_trainer, sorted_trainer, p_d, m_d,
                        dist_trainer.t_cache)

        # Dense config-1 steps with --turbo through the sharded step: K1
        # and K2. A 1 x 1 mesh never warms the dense march (the JAX
        # package's gate), so its twin is the Trainer without warm start.
        cfg1 = train_cli.build_config(train_cli.make_parser().parse_args([
            "--cameras", os.path.join(tmp, "data", "cameras.json"),
            "--stages", "1", "--steps", str(DIST_STEPS), "--turbo",
            "--scene-out", os.path.join(tmp, "dist_c1", "scene.json"),
            "--steps-dir", os.path.join(tmp, "dist_c1", "steps"),
            "--checkpoint-dir", ""]))
        ds1 = build_dataset(cfg1, device=dev)
        dist_c1 = DistributedTrainer(cfg1, ds1, data=1, model=1,
                                     log=lambda s: None)
        p_d, m_d, launches_c1, seconds, memory_c1 = sharded_run(dist_c1)
        eager_c1 = EagerDistributed(cfg1, ds1, data=1, model=1,
                                    log=lambda s: None)
        p_e, _, _, seconds_eager, _ = sharded_run(eager_c1)
        ran = [graphs_event(dist_c1), graphs_event(eager_c1)]
        if [ev["graphs"] for ev in ran] != [True, False]:
            raise AssertionError(f"1x1 NCCL dense modes {ran}")
        plain_c1 = Trainer(dataclasses.replace(cfg1, warm_start=False), ds1,
                           log=lambda s: None)
        p_t, m_t = plain_c1.run()
        err_c1 = max_gap(p_d, p_t)
        err_c1_eager = max_gap(p_d, p_e)
        emit("distributed_c1", mesh=[1, 1], steps=DIST_STEPS, modes=ran,
             max_param_err_vs_eager_sharded_run=err_c1_eager,
             max_param_err_vs_trainer=err_c1, tol=0.0, seconds=seconds,
             seconds_eager=seconds_eager, memory=memory_c1,
             launches=launches_c1)
        check_close(failures, "1x1 captured dense DistributedTrainer vs the "
                    "same run one step at a time", err_c1_eager, 0.0)
        check_close(failures, "1x1 dense DistributedTrainer vs Trainer",
                    err_c1, 0.0)
        require_launches(launches_c1, list(c1_counters()), "1x1 dense")
        step_c1 = modes("dist_c1", dist_c1, plain_c1, p_d, m_d)
        emit("distributed_steps", c4=step_c4, c1=step_c1)
    finally:
        dist.destroy_process_group()

    # (b) Two model ranks on the one card over gloo: the union-table march
    # launches K3 on [B/2, 2K] tables; held against the 1-rank march on
    # the same union table (K3, the JAX sharding tests' tolerances) and
    # against the plain march (K3's own noise tolerances).
    _, c_mask, c, r = knot_cloud(torch, dev, C4_INIT_N)
    args, _ = c4_tiles(torch, dev, c, r, c_mask)
    order = torch.as_tensor(morton_order(c.cpu().numpy()), device=dev)
    path = os.path.join(tmp, "dist_inputs.pt")
    torch.save({"c": c[order], "r": r[order], "mask": c_mask[order],
                "ro3": args[0], "rd3": args[1],
                "budget": torch.tensor(C4_BUDGET // 2)}, path)
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(rank, 2, port, path))
             for rank in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"the 2-rank march failed: exit codes "
                             f"{[p.exitcode for p in procs]}")
    ranks = [torch.load(f"{path}.rank{k}.pt") for k in range(2)]
    seconds = round(time.perf_counter() - t0, 3)
    # The union table of every tile: each rank's K-block, in rank order.
    union = [torch.cat([rk["tables"][i] for rk in ranks], dim=1).to(dev)
             for i in range(3)]
    u_args = (args[0], args[1], *union)
    t1, n1 = k3.culled_march_normals(*u_args, C4_K)
    t1w, n1w = k3.culled_march_normals(*u_args, C4_K, num_steps=16,
                                       t_init=(t1 * 0.8).contiguous())
    t_p, n_p = culled_march_normals_xla(*u_args, C4_K)
    out = {}
    for label, (t_ref, n_ref), key in (("cold", (t1, n1), "cold"),
                                       ("warm16", (t1w, n1w), "warm")):
        hit = (t_ref[..., 0] < 5.0).cpu()
        for k_r, rk in enumerate(ranks):
            dt = float(((rk[f"t_{key}"] - t_ref.cpu()).abs()
                        - 2e-5 * t_ref.cpu().abs()).max())
            dn = float((rk[f"n_{key}"] - n_ref.cpu()).abs()[hit].max())
            check_close(failures, f"union march {label} t rank {k_r} "
                        f"(excess over rtol 2e-5)", dt, 2e-5)
            check_close(failures, f"union march {label} normals rank {k_r}",
                        dn, 1e-3)
            out[f"{label}_rank{k_r}"] = {"t_excess_over_rtol": dt,
                                         "normal_hit_max_err": dn}
    plain_gap = march_errors(torch, ranks[0]["t_sharded_plain"].to(dev),
                             ranks[0]["n_sharded_plain"].to(dev), t_p, n_p)
    # K3 against its plain version at the union shape (one rank's slice of
    # tiles against its [B/2, 2K] union rows).
    half = args[0].shape[0] // 2
    u_slice = tuple(a[:half].contiguous() for a in u_args)
    union_case = k3_case(torch, u_slice, C4_K, 16,
                         (t1[:half] * 0.8).contiguous(), "union shape",
                         failures)
    graphs = [rk["graphs"] for rk in ranks]
    emit("distributed_model_axis", ranks=2, backend="gloo (one card)",
         graphs=graphs, why="one step at a time: gloo stages CUDA tensors "
         "through host memory, which a CUDA graph cannot record (NCCL takes "
         "one card per rank)",
         tiles=args[0].shape[0], per_rank_table=C4_BUDGET // 2,
         union_table=union[0].shape[1], vs_one_rank_k3=out,
         sharded_plain_vs_plain_on_union=plain_gap,
         launches_per_rank=[rk["launches"] for rk in ranks],
         union_shape=union_case, seconds=seconds)
    if any(rk["launches"] != 2 for rk in ranks):
        raise AssertionError("the union-table march did not launch K3 once "
                             "per march on every rank")
    if any(graphs):
        raise AssertionError("a gloo mesh must run its steps one at a time")

    # (c) Two NCCL ranks, one per card: the sharded trainer captured against
    # itself one step at a time (tests/test_torch_sharded_chunk.py's case
    # (d)), where the machine has two cards.
    if torch.cuda.device_count() < 2:
        emit("distributed_nccl_2card", ran=False, why="one card")
    else:
        two_card(torch, tmp, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    launches = {name: launches_c4[name] + launches_c1[name]
                for name in launches_c4}
    launches["culled_march"] += sum(rk["launches"] for rk in ranks)
    shape = {f"union_{key}": union_case[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "table",
        "tiles", "valid_slots")}
    return launches, shape


_PALLAS = "burn_raymarching_tpu/ops/pallas/"
_SCRIPTS = "scripts/"
_CSRC = "burn_raymarching_tpu_torch/csrc/"
SOURCES = {
    "march_shade": (_CSRC + "march_shade.cu",
                    _PALLAS + "march_shade_kernel.py:192"),
    # The table build of the TPU kernel's wrapper (no kernel of its own).
    "march_pack": (_CSRC + "march_shade.cu",
                   _PALLAS + "march_shade_kernel.py:237"),
    # The table build of the TPU kernel's wrapper (no kernel of its own).
    "shade_pack": (_CSRC + "shade.cu", _PALLAS + "shade_kernel.py:345"),
    "shade_fwd": (_CSRC + "shade.cu", _PALLAS + "shade_kernel.py:265"),
    # The TPU backward summed over its sequential grid; here the sum over
    # blocks is part of the launch (the ``sum_*`` fields).
    "shade_bwd": (_CSRC + "shade.cu", _PALLAS + "shade_kernel.py:283"),
    "culled_march": (_CSRC + "culled_march.cu",
                     _PALLAS + "culled_march_kernel.py:154"),
    # K6: no TPU kernel (the JAX package leaves the culled tail to XLA).
    "culled_shade_fwd": (_CSRC + "culled_shade.cu", None),
    "culled_shade_bwd": (_CSRC + "culled_shade.cu", None),
    "repulsion_fwd": (_CSRC + "repulsion.cu",
                      _PALLAS + "repulsion_kernel.py:205"),
    "repulsion_bwd": (_CSRC + "repulsion.cu",
                      _PALLAS + "repulsion_kernel.py:227"),
    # K7: no TPU kernel (the JAX package leaves selection to XLA).
    "tile_select": (_CSRC + "tile_select.cu", None),
    # K5: on no training or quality path; phase 17 drives it.
    "march_variants": (_CSRC + "march_variants.cu",
                       _SCRIPTS + "exp_march_variants.py:116"),
}
# The kernels that no training path runs, counted on phase 17's path.
VARIANT_KERNELS = ("march_variants",)
# K6 runs on no quality path of this run: the headline recipe's polish stage
# shades with gaussian coverage (the plain tail), and refine's acceptance
# loss takes no gradient.
NO_QUALITY_PATH = ("culled_shade_fwd", "culled_shade_bwd")


# Phase 14: the bench's launches per variant, by wrapper name (the
# ``kernels`` line's names → the wrappers' __name__).
BENCH_ONCE_PER_STEP = {"plain": (),
                       "kernel": ("march_shade", "march_pack"),
                       "warm": ("march_shade", "march_pack", "shade_pack",
                                "shade_fwd", "shade_bwd")}
BENCH_LARGE_KERNELS = ("culled_march", "repulsion_fwd", "repulsion_bwd")


def flagship_k3(torch, dev, failures: list) -> dict:
    """K3 at the bench flagship's shape (tools/bench.large_flagship): one
    step's batch, sampled and sorted as the step samples it, in 32 tiles
    of 512 rays against hierarchical top-256 tables of the 51,200-sphere
    cloud (cluster group 64, cluster budget 32), 16 warm steps from the
    Trainer's prefilled t cache x warm_backoff, at the last stage's
    smooth_k → k3_case's figures."""
    from burn_raymarching_tpu_torch.data.dataset import gather_batch
    from burn_raymarching_tpu_torch.models.scene import activate
    from burn_raymarching_tpu_torch.tools import bench
    from burn_raymarching_tpu_torch.tools import bench_large as bl
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from burn_raymarching_tpu_torch.train.step_body import (
        culled_tables,
        sample_step_indices,
        schedule_for_step,
    )

    cfg = bench.flagship_config()
    ds = bl.make_dataset(10 * 256 * 256, 256, dev)
    padded, mask = bl.make_params(LARGE_INIT_N, dev)
    tr = Trainer(cfg, ds, log=lambda s: None)
    tr.t_cache = tr._init_t_cache()
    tr.prefill_t_cache(padded, mask, cfg.max_smooth_k)
    clusters = tr._build_cluster_table(padded, mask)
    _, k, ratio, _ = schedule_for_step(cfg, cfg.stages - 1, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fg, n_fg = tr._sample_fg
    idx = torch.sort(sample_step_indices(
        cfg, gen, ds.packed.shape[0], fg, n_fg, cfg.batch_size,
        ratio)).values
    ro, rd, _ = gather_batch(ds.packed, idx)
    b, tile = cfg.batch_size // cfg.cull_tile, cfg.cull_tile
    with torch.no_grad():
        c, _, r, _, _ = activate(padded)
        _, _, cs, rs, qs = culled_tables(cfg, ro, rd, c, r, k, mask,
                                         clusters)
    args = (ro.reshape(b, tile, 3), rd.reshape(b, tile, 3), cs, rs, qs)
    t0 = (tr.t_cache[idx] * cfg.warm_backoff).reshape(b, tile, 1)
    return k3_case(torch, args, k, cfg.warm_steps, t0.contiguous(),
                   "flagship warm", failures)


def phase_bench(torch, dev, tmp: str) -> tuple[dict, dict]:
    """tools/bench.main at full width (its stdout line captured: exactly
    one JSON line with bench.py's four keys, vs_baseline > 1) → the
    launches of the bench's path per kernel. Each variant's launches (the
    bench sets every count to 0 before a variant and reads them after it;
    a replay counts once per graph launch, train/chunk.py): ``plain`` none,
    ``kernel`` K1 and its pack once per step run, ``warm`` K1, its pack, K2
    pack, fwd and bwd once per step plus K1 and its pack once per prefill
    chunk; the flagship K3 and K4 fwd and bwd. Then the captured warm bench
    step held to the same 8 steps one at a time, bitwise, from the same
    start and seed, and again after the bench's reset to the start; and K3
    held against its plain version at the flagship's shape
    (``flagship_k3``) → (launches, K3's figures there)."""
    import contextlib
    import io

    from burn_raymarching_tpu_torch.tools import bench

    names = {name: fn.__name__ for name, fn in kernel_counters().items()}
    out = os.path.join(tmp, "bench.json")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = bench.main(["--out", out])
    seconds = round(time.perf_counter() - t0, 3)
    lines = buf.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    with open(out) as f:
        res = json.load(f)
    if code not in (0, 2):
        raise AssertionError(f"bench exited {code}")
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} stdout lines")
    line = json.loads(lines[0])
    if set(line) != {"metric", "value", "unit", "vs_baseline"} or line[
            "metric"] != "train_step_rays_per_s_per_chip":
        raise AssertionError(f"bench line {line}")
    launches = {name: 0 for name in names}
    failures = []
    pixels, batch = res["pixels"], res["batch"]
    for variant, rec in res["variants"].items():
        got = rec["launches"]
        steps = rec["steps_run"]
        prefill = -(-pixels // batch) if variant == "warm" else 0
        want = {name: 0 for name in names}
        for name in BENCH_ONCE_PER_STEP[variant]:
            want[name] = steps + (prefill if name.startswith("march")
                                  else 0)
        seen = {name: got.get(names[name], 0) for name in names}
        if seen != want:
            failures.append(f"{variant}: launches {seen}, expected {want}")
        for name in names:
            launches[name] += seen[name]
        emit(f"bench_{variant}", **{k: v for k, v in rec.items()
                                    if k != "launches"}, launches=seen)
    large = res["large"]
    seen = {name: large["launches"].get(names[name], 0) for name in names}
    for name in names:
        launches[name] += seen[name]
    emit("bench_large", **{k: v for k, v in large.items()
                           if k != "launches"}, launches=seen)
    missing = [k for k in BENCH_LARGE_KERNELS if seen[k] <= 0]
    if missing:
        failures.append(f"flagship launched none of {missing}")
    if not large["graphs"] or large["host_launches_per_step"] > 3.0:
        failures.append(f"flagship: graphs {large['graphs']}, "
                        f"{large['host_launches_per_step']} host launch "
                        f"calls a step")
    gaps = bench.replay_matches_steps("warm", dev)
    emit("bench", line=line, exit_code=code, seconds=seconds,
         card=res["card"], batch=batch, pixels=pixels,
         captured_vs_one_at_a_time_warm=gaps, launches=launches)
    if line["vs_baseline"] <= 1.0:
        failures.append(f"vs_baseline {line['vs_baseline']} <= 1")
    if any(gap != 0.0 for gap in gaps.values()):
        failures.append(f"captured warm bench step vs one at a time: {gaps}")
    k3 = flagship_k3(torch, dev, failures)
    emit("kernel", name="culled_march_flagship", cull_budget=256,
         hier=True, **k3)
    if failures:
        raise AssertionError("bench: " + "; ".join(failures))
    return launches, {f"flagship_{key}": k3[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
        "valid_slots", "table")}


# Phase 15: the entry forward's largest gap to the same forward in float64
# (the CPU tests see 1.5e-5 at 32 x 32 rays); the dry run's parts on the two
# gloo ranks that share the card: K3 in the sharded step and on the union
# table.
ENTRY_TOL_F64 = 1e-4
GLOO_PARTS = ("kernel", "union")


def dryrun_k3_inputs(torch, dev) -> dict:
    """The tables K3 marches in the dry run's parts (d) and (e)
    (tools/dryrun_multichip): the 12-sphere cloud init of the dry run's
    trainers on the 32 x 32 rig, in tiles of 16 rays at the first step's
    smooth_k. Of the rig's 64 tiles, the two in which the plain march
    against every sphere hits most rays form the batch (a random batch of
    two tiles hits none of the 0.03-radius spheres on most draws, and the
    hold reads its t and normal errors on hit rays). Part (d): the flat
    top-8 per tile ([2, 16] rays, K = 8). Part (e), at 1 x 2: each model
    shard's hierarchical top-8 (cluster group 8, cluster budget 2) of its
    half of the Morton-sorted rows, padded to the DistributedTrainer's
    bucket of 16, joined in rank order as the union table, of which model
    rank 0 marches its one tile ([1, 16] rays, 2 x 8 slots) → {part: (ro3,
    rd3, cs, rs, qs, smooth_k, cfg)}."""
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.models.scene import (
        SceneParams,
        activate,
        pad_params,
    )
    from burn_raymarching_tpu_torch.ops.culling import (
        PrimitiveClusters,
        morton_order,
    )
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.tools import dryrun_multichip as dm
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from burn_raymarching_tpu_torch.train.step_body import (
        culled_tables,
        schedule_for_step,
    )

    ds = dm.rig_dataset(dev)
    ro_all, rd_all = ds.packed[:, :3], ds.packed[:, 3:6]
    out = {}
    for part, kw, model in (("kernel", dm.CFG_K, 1),
                            ("union", dm.CFG_FULL, 2)):
        cfg = TrainConfig(batch_size=32, **kw)
        tr = Trainer(cfg, ds, log=lambda s: None)
        params = tr._init_params()
        _, k, _, _ = schedule_for_step(cfg, 0, 1)
        tile = cfg.cull_tile
        with torch.no_grad():
            c, _, r, _, _ = activate(params)
            n_tiles = ro_all.shape[0] // tile
            t_all, _ = culled_march_normals_xla(
                ro_all.reshape(n_tiles, tile, 3),
                rd_all.reshape(n_tiles, tile, 3),
                c.expand(n_tiles, -1, -1), r.reshape(1, -1).expand(
                    n_tiles, -1), (c * c).sum(dim=1).expand(n_tiles, -1), k)
            hits = (t_all[..., 0] < 10.0).sum(dim=1)
            tiles = torch.sort(torch.topk(hits, 2).indices).values
            rows = (tiles[:, None] * tile
                    + torch.arange(tile, device=dev)).reshape(-1)
            ro, rd = ro_all[rows], rd_all[rows]
            if model == 1:
                padded, mask = pad_params(params, tr._bucket(params.n))
                c, _, r, _, _ = activate(padded)
                _, _, cs, rs, qs = culled_tables(cfg, ro, rd, c, r, k, mask)
            else:
                order = torch.as_tensor(morton_order(c.cpu().numpy()),
                                        device=dev)
                padded, mask = pad_params(SceneParams(
                    params.centers[order], params.colors[order],
                    params.radii[order], params.light_dir, params.ambient),
                    16)
                c, _, r, _, _ = activate(padded)
                m_local, g = 16 // model, cfg.cull_cluster_group
                shards = []
                for m in range(model):
                    own = slice(m * m_local, (m + 1) * m_local)
                    clusters = PrimitiveClusters(
                        torch.arange(m_local, device=dev).reshape(-1, g),
                        mask[own].bool().reshape(-1, g))
                    shards.append(culled_tables(
                        cfg, ro, rd, c[own], r[own], k, mask[own],
                        clusters)[2:])
                cs, rs, qs = (torch.cat([sh[i] for sh in shards], dim=1)[:1]
                              for i in range(3))
                ro, rd = ro[:tile], rd[:tile]
        b = ro.shape[0] // tile
        out[part] = (ro.reshape(b, tile, 3).contiguous(),
                     rd.reshape(b, tile, 3).contiguous(), cs.contiguous(),
                     rs.contiguous(), qs.contiguous(), k, cfg)
    return out


def dryrun_k3(torch, dev, failures: list) -> dict:
    """K3 against its plain version at the dry run's shapes
    (``dryrun_k3_inputs``), cold (the step's 40 march steps) and warm (its
    4 warm steps from warm_backoff x the cold t), with k3_case's
    float64-based tolerances → {part: {"cold": figures, "warm": figures}}."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3

    out = {}
    for part, (*args, k, cfg) in dryrun_k3_inputs(torch, dev).items():
        t_cold, _ = k3.culled_march_normals(*args, k,
                                            num_steps=cfg.render.march_steps)
        out[part] = {
            "cold": k3_case(torch, args, k, cfg.render.march_steps, None,
                            f"dry run {part} cold", failures),
            "warm": k3_case(torch, args, k, cfg.warm_steps,
                            (t_cold * cfg.warm_backoff).contiguous(),
                            f"dry run {part} warm", failures)}
    return out


def phase_dryrun(torch, dev) -> tuple[dict, dict]:
    """tools/dryrun_multichip on the card (the port of __graft_entry__.py):
    the entry forward (16,384 rays against 128 slots), finite and within
    ENTRY_TOL_F64 of the same forward in float64; K3 held against its
    plain version at the shapes of parts (d) and (e) (``dryrun_k3``); the
    dry run on one NCCL rank in this process (every part's steps replaying
    captured graphs, K3 launched on part (d)); its parts (d) and (e) on two
    gloo ranks sharing the card (1 x 2: K3 in the sharded step and on the
    union table, one step at a time); and with two or more cards all five
    parts on min(cards, 4) NCCL ranks, one per card →
    (the launches of the dry run's path per kernel, summed over its runs
    and ranks (every count set to 0 before each run), K3's figures at the
    dry run's shapes)."""
    import types

    from burn_raymarching_tpu_torch.models.scene import (
        PARAM_KEYS,
        scene_forward,
    )
    from burn_raymarching_tpu_torch.tools import dryrun_multichip as dm

    failures = []
    names = {name: fn.__name__ for name, fn in kernel_counters().items()}
    launches = {name: 0 for name in names}

    def spawned(n: int, backend: str, parts: tuple = dm.PARTS) -> tuple:
        """A dry run of ``parts`` on n spawned ranks → (its summary, its
        launches per kernel summed over its parts and ranks, seconds)."""
        t = time.perf_counter()
        s = dm.dryrun_multichip(n, "cuda", backend, parts)
        mine = {name: sum(p["launches"].get(names[name], 0)
                          for p in s["parts"].values()) for name in names}
        return s, mine, round(time.perf_counter() - t, 3)

    def check(label: str, n: int, graphs: bool, s: dict, mine: dict,
              seconds: float, parts: tuple = dm.PARTS) -> None:
        """One dry run's summary of ``parts``, checked: the JAX mesh,
        finite losses, every part's graphs as ``graphs`` says, K3 launched
        on (d) and (e); its launches added to ``launches``."""
        emit(label, **s, seconds=seconds, launches=mine)
        for name in names:
            launches[name] += mine[name]
        data, model = dm.mesh_shape(n)
        if s["mesh"] != {"data": data, "model": model}:
            failures.append(f"{label}: mesh {s['mesh']}")
        for part, key in (("dense", "loss"), ("culled", "culled_loss")):
            if part in parts and not math.isfinite(s[key]):
                failures.append(f"{label}: {key} {s[key]}")
        want = [p for p in parts if p != "union" or model > 1]
        if list(s["parts"]) != want:
            failures.append(f"{label}: parts {list(s['parts'])}")
        for part, rec in s["parts"].items():
            if rec["graphs"] != [graphs] * n:
                failures.append(f"{label} {part}: graphs {rec['graphs']}")
            if part in ("kernel", "union") and rec["k3_launches"] <= 0:
                failures.append(f"{label} {part}: K3 not launched")

    t0 = time.perf_counter()
    fn, (params, ro, rd, k, mask) = dm.entry("cuda")
    with torch.no_grad():
        img = fn(params, ro, rd, k, mask)
        p64 = types.SimpleNamespace(**{
            key: getattr(params, key).detach().double() for key in PARAM_KEYS})
        img64 = scene_forward(p64, ro.double(), rd.double(), k, mask=mask)
    torch.cuda.synchronize()
    gap = float((img.double() - img64).abs().max())
    emit("dryrun_entry", shape=list(img.shape),
         finite=bool(torch.isfinite(img).all()), max_abs_err_vs_float64=gap,
         tol=ENTRY_TOL_F64, seconds=round(time.perf_counter() - t0, 3))
    if tuple(img.shape) != (dm.ENTRY_SIZE ** 2, 3):
        failures.append(f"entry forward shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        failures.append("entry forward is not finite")
    check_close(failures, "entry forward vs float64", gap, ENTRY_TOL_F64)

    k3_dry = dryrun_k3(torch, dev, failures)
    for part, cases in k3_dry.items():
        for mode, case in cases.items():
            emit("kernel", name=f"culled_march_dryrun_{part}_{mode}", **case)

    t0 = time.perf_counter()
    s, mine, _ = counted(torch, lambda: dm.dryrun_multichip(1, "cuda", "nccl"))
    check("dryrun_nccl_1", 1, True, s, mine,
          round(time.perf_counter() - t0, 3))
    # Parts (d) and (e) alone: (a)-(c) at model 2 run on the CPU tests'
    # gloo ranks and over NCCL below; on gloo ranks sharing the card part
    # (c)'s plain march stages ~6,000 all-reduces through host memory.
    check("dryrun_gloo_2", 2, False, *spawned(2, "gloo", GLOO_PARTS),
          GLOO_PARTS)
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("dryrun_nccl_multi", ran=False, why="one card")
    else:
        n = min(cards, 4)
        check(f"dryrun_nccl_{n}", n, True, *spawned(n, "nccl"))
    if launches["culled_march"] <= 0:
        failures.append("K3 was not launched on the dry run's path")
    if failures:
        raise AssertionError("dryrun: " + "; ".join(failures))
    return launches, {
        f"dryrun_{part}_{mode}_{key}": case[key]
        for part, cases in k3_dry.items() for mode, case in cases.items()
        for key in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                    "table", "tiles", "rays_per_tile", "valid_slots")}


DEFAULTS_STEPS = 20


def phase_defaults(torch, tmp: str) -> dict:
    """The port's library flow with no device named, on the dango set and
    the scene that phases 5 and 6 left in ``tmp``: the dataset, the
    training run and the scene, camera and cluster helpers must all land
    on the card → every kernel's launches on the training run."""
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.data.scene_io import load_scene_json
    from burn_raymarching_tpu_torch.models.scene import (
        init_scene_params,
        init_scene_params_cloud,
        params_from_numpy,
        params_to_numpy,
        raw_from_physical,
    )
    from burn_raymarching_tpu_torch.ops.culling import build_clusters
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    out = os.path.join(tmp, "defaults")
    cfg = TrainConfig(stages=TRAIN_STAGES, steps_per_stage=DEFAULTS_STEPS,
                      cameras_json=os.path.join(tmp, "data", "cameras.json"),
                      steps_dir=os.path.join(out, "steps"),
                      scene_json=os.path.join(out, "scene.json"),
                      checkpoint_dir="")
    ds = build_dataset(cfg)
    trainer = Trainer(cfg, ds, log=lambda s: None)
    (padded, mask), launches, seconds = counted(torch, trainer.run)
    final_loss = trainer.loss_history[-1]

    scene = load_scene_json(os.path.join(tmp, "scene.json"))
    raw = raw_from_physical(
        scene["centers"], scene["colors"], scene["radii"] + 0.01,
        light_dir=scene["light_dir"],
        ambient=float(scene["ambient_intensity"][0]))
    on = {"build_dataset": ds.device,
          "Trainer.run": padded.centers.device,
          "raw_from_physical": raw.centers.device,
          "params_from_numpy":
              params_from_numpy(params_to_numpy(raw)).centers.device,
          "init_scene_params": init_scene_params().centers.device,
          "init_scene_params_cloud":
              init_scene_params_cloud(cfg.init_n, seed=cfg.seed
                                      ).centers.device,
          "create_camera_rays": create_camera_rays(
              cfg.width, cfg.height, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0],
              50.0)[1].device,
          "build_clusters":
              build_clusters(scene["centers"]).member_idx.device}
    emit("defaults", stages=cfg.stages, steps_per_stage=cfg.steps_per_stage,
         batch=cfg.batch_size, slots=int(mask.shape[0]),
         final_n=int(mask.sum().item()), seconds=seconds,
         final_loss=final_loss, device=str(ds.device),
         on={name: str(dev) for name, dev in on.items()}, launches=launches)
    off = sorted(name for name, dev in on.items() if dev.type != "cuda")
    if off:
        raise AssertionError(f"not on the card without a device: {off}")
    require_launches(launches, list(c1_counters()), "library defaults")
    if not math.isfinite(final_loss):
        raise AssertionError(f"library defaults: final loss {final_loss}")
    return launches


# Phase 17: K5 at the variant tool's shape (16,384 rays, 100 live of 128
# slots, k = 18.5), 40 steps, VARIANT_TILE rays a block; the other block
# sizes must give the same bits. The two march tools run with one timing
# repeat each (their defaults take three).
VARIANT_TILE, VARIANT_STEPS = 128, 40
VARIANT_OTHER_TILES = (64, 1024)


def variant_counters() -> dict:
    """The training kernels' counters and K5's."""
    from burn_raymarching_tpu_torch.ops.cuda import march_variants_kernel as k5

    return {**kernel_counters(), "march_variants": k5.variant_march}


def variant_case(torch, k5, inp: dict, name: str, flags: tuple,
                 failures: list) -> dict:
    """K5 in one flag combination against its plain version: hit rays
    (t < 10) and all rays (relative) within ``march_noise_tols`` (5x the
    plain float32 version's own gap to float64, as for K3); for ``clamp``
    also the rays that the 1e-8 floor stalls (t >= 10 after 40 steps of
    ~1), in absolute t, within 5x their float32 gap to float64. Bitwise
    equal at VARIANT_OTHER_TILES. Times and bound: 2 SFU operations per
    (ray, live slot, evaluation), 47 evaluations a ray."""
    clamp, _, coord = flags
    prim = inp["prim_far"] if coord else inp["prim"]
    args = (inp["ro"], inp["rd"], inp["t0"], prim, inp["c_sq"], inp["k_arr"],
            VARIANT_STEPS)
    t_k, n_k = k5.variant_march(*args, VARIANT_TILE, *flags)
    t_p, n_p = k5.variant_march_plain(*args, VARIANT_TILE, *flags)
    t_64, n_64 = k5.variant_march_plain(*(a.double() for a in args[:6]),
                                        VARIANT_STEPS, VARIANT_TILE, *flags)
    errs = march_errors(torch, t_k, n_k, t_p, n_p)
    tols = march_noise_tols(torch, t_p, n_p, t_64, n_64)
    if clamp:
        stalled = t_p[:, 0] >= 10.0
        errs["stalled_rays"] = int(stalled.sum())
        if errs["stalled_rays"]:
            errs["max_abs_err_t_stalled"] = (
                t_k - t_p).abs()[stalled].max().item()
            tols["max_abs_err_t_stalled"] = 5.0 * (
                t_p.double() - t_64).abs()[stalled].max().item() + 1e-5
    for key, tol in tols.items():
        check_close(failures, f"K5 {name} {key}", errs[key], tol)
    for tile in VARIANT_OTHER_TILES:
        t_b, n_b = k5.variant_march(*args, tile, *flags)
        if not (torch.equal(t_b, t_k) and torch.equal(n_b, n_k)):
            failures.append(f"K5 {name}: tile_n {tile} differs bitwise from "
                            f"tile_n {VARIANT_TILE}")
    live = int(inp["mask"].sum())
    out = {"errors": errs, "tol": tols,
           "ms": time_ms(torch, lambda: k5.variant_march(
               *args, VARIANT_TILE, *flags)),
           "device_ms": graph_ms(torch, lambda: k5.variant_march(
               *args, VARIANT_TILE, *flags)),
           "plain_ms": time_ms(torch, lambda: k5.variant_march_plain(
               *args, VARIANT_TILE, *flags), reps=5),
           **march_bound(t_k.shape[0] * live * (VARIANT_STEPS + 7.0),
                         *args[:5], t_k, n_k)}
    emit("kernel", name="march_variants", variant=name,
         tile_n=VARIANT_TILE, steps=VARIANT_STEPS, slots=prim.shape[1],
         live=live, **out)
    return out


def variant_vs_k1(torch, k5, inp: dict, failures: list) -> dict:
    """K5's base against K1 on one table: K1's pack of the tool's scene,
    K5's centers from the pack's columns 0-2 and c_sq from its column 3,
    the radii as given; VARIANT_STEPS steps from t = 0. The base variant is
    K1's march, so the two must agree bitwise. Device ms of each (K1's
    wrapper packs its table first, one launch of ~0.001 ms), timed in
    turns K1, K5, K5, K1, and the ratio of their medians."""
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1

    ro, rd, c, r, mask = (inp[key] for key in ("ro", "rd", "centers",
                                               "radii", "mask"))
    k = inp["k_arr"]
    table = k1.pack_march_table(c, r, mask, k)
    args = (ro, rd, inp["t0"], torch.cat([table[:, :3].T, r.reshape(1, -1)])
            .contiguous(), table[:, 3:4].T.contiguous(), k, VARIANT_STEPS,
            VARIANT_TILE, False, False, False)

    def run_k1():
        return k1.march_shade(ro, rd, c, r, k, mask=mask,
                              num_steps=VARIANT_STEPS)

    t_5, n_5 = k5.variant_march(*args)
    t_1, n_1 = run_k1()
    bitwise = bool(torch.equal(t_5, t_1) and torch.equal(n_5, n_1))
    if not bitwise:
        failures.append("K5 base differs from K1 on the same table")
    times = {"k1": [], "k5": []}
    for who in ("k1", "k5", "k5", "k1"):
        times[who].append(graph_ms(torch, run_k1 if who == "k1" else (
            lambda: k5.variant_march(*args))))
    k1_ms, k5_ms = (statistics.median(times[w]) for w in ("k1", "k5"))
    out = {"bitwise": bitwise,
           "max_abs_dt": (t_5 - t_1).abs().max().item(),
           "max_abs_dn": (n_5 - n_1).abs().max().item(),
           "k5_device_ms": k5_ms, "k1_device_ms": k1_ms,
           "k5_device_ms_runs": times["k5"], "k1_device_ms_runs": times["k1"],
           "ratio": k5_ms / k1_ms}
    emit("k5_vs_k1", rays=ro.shape[0], slots=c.shape[0],
         live=int(mask.sum()), steps=VARIANT_STEPS, **out)
    return out


def phase_variants(torch, dev) -> tuple[dict, dict]:
    """K5's base against K1 on one table (``variant_vs_k1``), K5 against
    its plain version in all eight flag combinations, then
    the two march tools' main at full size (tools/exp_march_variants.py:
    16,384 rays, 128 slots, its three tables over every variant and block
    size; tools/roofline.py: 16,384 rays, 200 chained iterations) with
    every count set to 0 just before and read just after → (launches per
    kernel on that path, the ``kernels`` line's K5 row)."""
    from burn_raymarching_tpu_torch.ops.cuda import march_variants_kernel as k5
    from burn_raymarching_tpu_torch.tools import exp_march_variants as emv
    from burn_raymarching_tpu_torch.tools import roofline

    inp = emv.make_inputs(128, dev)
    failures = []
    vs_k1 = variant_vs_k1(torch, k5, inp, failures)
    cases = {name: variant_case(torch, k5, inp, name, flags, failures)
             for name, flags in emv.VARIANTS.items()}
    if failures:
        raise AssertionError("; ".join(failures))

    def tools():
        t0 = time.perf_counter()
        sweep = emv.main(["--reps", "1"])
        t1 = time.perf_counter()
        roof = roofline.main(["--reps", "1"])
        return sweep, roof, t1 - t0, time.perf_counter() - t1

    (sweep, roof, sweep_s, roof_s), launches, seconds = counted(
        torch, tools, variant_counters())
    emit("march_tools", seconds=seconds, exp_march_variants_s=sweep_s,
         roofline_s=roof_s, launches=launches,
         base_vs_plain_march=sweep["base_vs_plain_march"],
         deviation=sweep["deviation"], variant_ms=sweep["ms"],
         floor_ms=roof["floor_ms"], xcend_ms=roof["xcend_ms"],
         march_ms=roof["march_ms"], ratio=roof["ratio"], card=roof["card"])
    require_launches(launches, ("march_variants", "march_shade"),
                     "march tools")
    base = sweep["base_vs_plain_march"]
    check_close(failures, "exp_march_variants base vs plain march t",
                base["max_dt_hit"], MARCH_TOLS["max_abs_err_t_hit"])
    check_close(failures, "exp_march_variants base vs plain march normals",
                base["max_dn_hit"], MARCH_TOLS["max_abs_err_normal_hit"])
    times = [ms for row in sweep["ms"].values() for ms in row.values()]
    times += [*roof["xcend_ms"].values(), *roof["march_ms"].values(),
              *roof["ratio"].values(), roof["floor_ms"]]
    if not all(math.isfinite(x) and x > 0 for x in times):
        failures.append(f"march tools: a time is not positive: {times}")
    if failures:
        raise AssertionError("; ".join(failures))
    row = dict(max_abs_err=cases["base"]["errors"]["max_abs_err_t_hit"],
               **{key: cases["base"][key] for key in (
                   "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
               library_ms=None, tile_n=VARIANT_TILE, vs_k1=vs_k1,
               variants={name: {
                   "max_abs_err_t_hit": c["errors"]["max_abs_err_t_hit"],
                   "max_abs_err_normal_hit":
                       c["errors"]["max_abs_err_normal_hit"],
                   "ms": c["ms"], "device_ms": c["device_ms"],
                   "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"]}
                   for name, c in cases.items()})
    return launches, row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import burn_raymarching_tpu_torch  # noqa: F401  (sets TF32 off)

    dev = torch.device("cuda", 0)
    name = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch, dev)
    kernels.update(phase_kernels_c4(torch, dev))
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_generate_and_train(torch, tmp)
        launches.update(phase_c4(torch, dev, tmp))
        launches_refine, refine_shape = phase_refine_c4(torch, dev, tmp)
        launches_guard = phase_guard_c1(torch, tmp)
        launches_c5, c5_shape = phase_c5(torch, dev, tmp)
        launches_dist, union_shape = phase_distributed(torch, dev, tmp)
        launches_viewer, viewer_shape = phase_viewer(torch, dev, tmp)
        launches_bench, flagship_shape = phase_bench(torch, dev, tmp)
        launches_dryrun, dryrun_shape = phase_dryrun(torch, dev)
        launches_defaults = phase_defaults(torch, tmp)
    launches_variants, kernels["march_variants"] = phase_variants(torch, dev)
    kernels["culled_march"].update(refine_shape, **c5_shape, **union_shape,
                                   **flagship_shape, **dryrun_shape)
    kernels["march_shade"].update(viewer_shape)
    # ``launches``: the two training paths (phases 6 and 8);
    # ``launches_quality``: the refine and guard paths (phases 9 and 10);
    # ``launches_c5``, ``launches_distributed``, ``launches_viewer``,
    # ``launches_bench``, ``launches_dryrun`` and ``launches_defaults``:
    # phases 11, 12, 13, 14, 15 and 16; ``launches_variants``: phase 17,
    # the march tools' path, the only one that runs K5.
    # Every path had its counts set to 0 just before it and read after it,
    # and every training kernel but K6 is counted on one of the two quality
    # paths.
    quality = {**launches_guard, **launches_refine}
    training = set(SOURCES) - set(VARIANT_KERNELS) - set(NO_QUALITY_PATH)
    if set(quality) != training:
        raise AssertionError(f"kernels not counted on a quality path: "
                             f"{sorted(training - set(quality))}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": launches.get(k, 0),
         "launches_quality": quality.get(k, 0),
         "launches_c5": launches_c5.get(k, 0),
         "launches_distributed": launches_dist.get(k, 0),
         "launches_viewer": launches_viewer.get(k, 0),
         "launches_bench": launches_bench.get(k, 0),
         "launches_dryrun": launches_dryrun.get(k, 0),
         "launches_defaults": launches_defaults.get(k, 0),
         "launches_variants": launches_variants[k], **kernels[k]}
        for k in SOURCES]}), flush=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

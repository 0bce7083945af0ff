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
                   table holds) the same way; K4 forward and
                   backward against autograd of the plain versions, member
                   and monopole, at C = 80 (config 4) and C = 800
                   (M = 51,200), with a bitwise repeat check of its
                   results and its sums over blocks against one PyTorch
                   ``sum`` of the same parts;
  5. generate    — the port's generator writes the dango dataset (10 views at
                   256²) into a temporary directory;
  6. train       — train_cli at config-1 width (batch 16,384, reference init,
                   default flags, kernels on) for 2 stages x 100 steps, which
                   crosses one density-control boundary and exports
                   scene.json; K1 and K2's launch counters must have grown
                   during it; then the final loss, train-view PSNR and
                   steady-state rays/s of the kernel step and of the
                   --no-pallas step, and the kernel step's device-busy
                   time and each hand-written kernel's share of it
                   (torch.profiler);
  7. generate_c4 — the generator writes the config-4 knot set (30 views at
                   512², 400 GT spheres, GT k 128, sharpness 40);
  8. train_c4    — train_cli with the config-4 recipe (tools/run_c5.py) cut to
                   2 stages x 100 steps, which still crosses one density
                   boundary with the merge; K3 and K4's launch counters must
                   have grown; the loss must be finite and the culled
                   train-view PSNR above the init's, measured in this run;
                   then steady-state rays/s of the kernel and --no-pallas
                   steps and the kernel step's device-busy share
                   (torch.profiler).
The line before the last is {"kernels": [...]}: per kernel its launches on
the training path, error, ``ms`` (the wrapper call between CUDA events),
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
LIBRARIES = ("march_shade", "shade", "culled_march", "repulsion", "noop")
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
    """K1 / K3: one sqrt and one exp per (point, live primitive) pair, with
    ~12 other FP32 operations around them."""
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
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
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
        library_ms=None)

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


def knot_cloud(torch, dev, n: int):
    """The prior-seeded cloud init of ``n`` spheres around the generator's
    400-sphere knot (points.json, jitter 0.02), padded to its bucket →
    (padded, mask, centers, radii) with the last two activated and
    detached."""
    from burn_raymarching_tpu_torch.models.scene import (
        activate,
        init_scene_params_cloud,
        pad_params,
    )
    from burn_raymarching_tpu_torch.tools.generate import knot_scene
    from burn_raymarching_tpu_torch.utils import bucket_size

    pts, _, _ = knot_scene(C4_GT_N)
    params = init_scene_params_cloud(n, seed=0, points=pts, jitter=0.02,
                                     device=dev)
    padded, mask = pad_params(params, bucket_size(n))
    c, _, r, _, _ = activate(padded)
    return padded, mask, c.detach(), r.detach()


def c4_tiles(torch, dev, c, r, mask):
    """32 tile-coherent ray tiles of the config-4 rig and their top-K
    tables: Morton tiles of 4 random views, selected against the whole
    primitive table, 32 picked among those whose selection is not empty."""
    import numpy as np

    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching_tpu_torch.tools.generate import ring_cameras
    from burn_raymarching_tpu_torch.utils import morton_permutation

    rng = np.random.default_rng(0)
    perm = torch.as_tensor(morton_permutation(C4_SIZE, C4_SIZE), device=dev)
    cams = ring_cameras(C4_VIEWS)
    ro_all, rd_all = [], []
    for v in rng.choice(C4_VIEWS, 4, replace=False):
        ro, rd = create_camera_rays(C4_SIZE, C4_SIZE, cams[v]["origin"],
                                    cams[v]["target"], cams[v]["fov"],
                                    device=dev)
        ro_all.append(ro[perm])
        rd_all.append(rd[perm])
    ro, rd = torch.cat(ro_all), torch.cat(rd_all)
    idx, valid = select_tile_primitives(tile_cones(ro, rd, C4_TILE), c, r,
                                        C4_K, C4_BUDGET, mask=mask)
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


def step_runner(torch, trainer, final, mask, t_cache=None):
    """The trainer's full step (sample, forward, loss, backward, Adam) on a
    fresh copy of the padded ``final`` params, with the trainer's sampling
    pools, cluster table, frozen repulsion prep and a copy of ``t_cache``
    (for warm-started configs) → one(step)."""
    from burn_raymarching_tpu_torch.models.scene import (
        pad_params,
        unpad_params,
    )
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static
    from burn_raymarching_tpu_torch.train.optimizer import (
        make_optimizer,
        set_group_lrs,
    )

    cfg, ds = trainer.cfg, trainer.dataset
    padded, _ = pad_params(unpad_params(final, int(mask.sum())), final.n)
    opt = make_optimizer(cfg, padded)
    gen = torch.Generator(device=ds.device)
    gen.manual_seed(1)
    clusters = trainer._build_cluster_table(padded, mask)
    rep_static = (build_repulsion_static(padded.centers, clusters, mask)
                  if cfg.cluster_repulsion else None)
    fg_pool, n_fg = trainer._sample_fg
    cache = None if t_cache is None else t_cache.clone()

    def one(step):
        _, lr = trainer.step_fn(padded, gen, cfg.stages - 1, step, mask,
                                ds.packed, fg_pool, n_fg, t_cache=cache,
                                clusters=clusters, rep_static=rep_static)
        set_group_lrs(opt, lr, trainer.lr_scales)
        opt.step()

    return one


def step_rate(torch, trainer, final, mask, steps: int = 30,
              t_cache=None) -> float:
    """Steady-state rays/s of ``step_runner``'s step after 5 warm-up steps,
    host clock around synchronized work."""
    one = step_runner(torch, trainer, final, mask, t_cache)
    for s in range(1, 6):
        one(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(6, 6 + steps):
        one(s)
    torch.cuda.synchronize()
    return steps * trainer.cfg.batch_size / (time.perf_counter() - t0)


# The __global__ functions under csrc/, as a trace names them.
HAND_KERNELS = ("march_shade_kernel", "march_pack_kernel",
                "culled_march_kernel", "shade_pack_kernel",
                "shade_fwd_kernel", "shade_bwd_kernel", "rep_fwd_kernel",
                "rep_bwd_kernel")


def device_profile(torch, trainer, final, mask, t_cache, steps: int = 10
                   ) -> dict:
    """torch.profiler over ``steps`` steady steps, read from its trace's
    device events (kernels, copies, memsets; not the annotation spans that
    the trace also places on the device) → busy device time per step (the
    union of their intervals), events per step, the five kernel names
    with the most device time, and the device time of each hand-written
    kernel (HAND_KERNELS) that ran."""
    from torch.profiler import ProfilerActivity, profile

    one = step_runner(torch, trainer, final, mask, t_cache)
    for s in range(1, 4):
        one(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(4, 4 + steps):
            one(s)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "")) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    busy_us, end = 0.0, -math.inf
    by_name: dict = {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    hand = {k: sum(d for name, d in by_name.items() if k in name)
            for k in HAND_KERNELS}
    return {"device_busy_ms_per_step": busy_us / 1000.0 / steps,
            "device_events_per_step": len(spans) / steps,
            "top_kernels_ms_per_step": [[k[:60], d / 1000.0 / steps]
                                        for k, d in top],
            "hand_kernels_ms_per_step": {k: d / 1000.0 / steps
                                         for k, d in hand.items() if d > 0}}


def phase_generate_and_train(torch) -> dict:
    """generate + train (config 1) → K1 and K2's launch counts on that
    path."""
    import numpy as np

    from burn_raymarching_tpu_torch.data.scene_io import load_cameras
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
    from burn_raymarching_tpu_torch.ops.cuda import shade_kernel as k2
    from burn_raymarching_tpu_torch.tools import generate, train_cli
    from burn_raymarching_tpu_torch.train.evaluate import evaluate_views
    from burn_raymarching_tpu_torch.data.image_io import load_image_as_array
    from burn_raymarching_tpu_torch.train.loop import Trainer

    counters = {"march_shade": k1.march_shade,
                "march_pack": k1.pack_march_table,
                "shade_pack": k2.pack_shade_table,
                "shade_fwd": k2.launch_shade_fwd,
                "shade_bwd": k2.launch_shade_bwd}
    with tempfile.TemporaryDirectory() as tmp:
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
             rays_per_s_plain=rate_plain, wall_ms_per_step=wall_ms,
             device_busy_share=prof["device_busy_ms_per_step"] / wall_ms,
             **prof, launches=launches,
             all_finite=bool(np.isfinite(
                 np.asarray(scene["centers"] + scene["radii"])).all()))
        if not (math.isfinite(final_loss) and ev["mean"] > MIN_PSNR_DB):
            raise AssertionError(f"bad training result: loss {final_loss}, "
                                 f"PSNR {ev['mean']} (need > {MIN_PSNR_DB})")

    return launches


def phase_c4(torch) -> dict:
    """generate_c4 + train_c4 → K3 and K4's launch counts on that path."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4
    from burn_raymarching_tpu_torch.tools import generate, run_c5, train_cli
    from burn_raymarching_tpu_torch.train.loop import Trainer

    counters = {"culled_march": k3.culled_march_normals,
                "repulsion_fwd": k4.launch_rep_fwd,
                "repulsion_bwd": k4.launch_rep_bwd}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        generate.main(run_c5.generate_argv(data, views=C4_VIEWS,
                                           size=C4_SIZE, gt_n=C4_GT_N))
        emit("generate_c4", views=C4_VIEWS, size=C4_SIZE, gt_n=C4_GT_N,
             seconds=round(time.perf_counter() - t0, 3))

        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer, padded, mask = train_cli.main(run_c5.recipe_argv(
            data, tmp, size=C4_SIZE, init_n=C4_INIT_N, steps=TRAIN_STEPS,
            stages=TRAIN_STAGES, cull_budget=C4_BUDGET))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        missing = [name for name, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the config-4 "
                                 f"path: {missing}")

        cfg = trainer.cfg
        final_loss = trainer.loss_history[-1]
        t0 = time.perf_counter()
        psnr_init = run_c5.views_psnr(trainer, *run_c5.init_padded(trainer),
                                      cull=trainer._cull_render())
        psnr = run_c5.views_psnr(trainer, padded, mask,
                                 cull=trainer._cull_render())
        eval_s = (time.perf_counter() - t0) / 2
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
             seconds=round(train_s, 3), final_n=int(mask.sum().item()),
             final_loss=final_loss, loss_history=trainer.loss_history,
             psnr_init=psnr_init, psnr_trained=psnr,
             eval_seconds_per_pass=round(eval_s, 3),
             rays_per_s_kernels=rate_kernels, rays_per_s_plain=rate_plain,
             wall_ms_per_step=wall_ms,
             device_busy_share=prof["device_busy_ms_per_step"] / wall_ms,
             **prof,
             launches=launches)
        if not (math.isfinite(final_loss) and psnr > psnr_init):
            raise AssertionError(f"bad config-4 result: loss {final_loss}, "
                                 f"PSNR {psnr} (init {psnr_init})")
    return launches


_PALLAS = "burn_raymarching_tpu/ops/pallas/"
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
    "repulsion_fwd": (_CSRC + "repulsion.cu",
                      _PALLAS + "repulsion_kernel.py:205"),
    "repulsion_bwd": (_CSRC + "repulsion.cu",
                      _PALLAS + "repulsion_kernel.py:227"),
}


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
    launches = phase_generate_and_train(torch)
    launches.update(phase_c4(torch))
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": launches[k], **kernels[k]}
        for k in SOURCES]}), flush=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

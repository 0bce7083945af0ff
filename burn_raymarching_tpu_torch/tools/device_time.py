"""The device-time yardstick of the port's measurements: torch.profiler's
trace of a few calls, read as the device-busy time per call (the union of
the kernel, copy and memset intervals), the device events per call, the
kernels with the most device time, each hand-written kernel's share, and
the launches the host made per call (kernel launches, copies, memsets and
CUDA-graph launches, each one runtime or driver call). Kernels that a
CUDA-graph replay runs appear as device events like any other.

``tools/bench.py``, ``tools/bench_large.py`` and
``tools/dryrun_multichip.py`` report these numbers (``chained_ms`` times
the march tools' chained calls), and ``PERF.md`` compares them across PRs.
Change what this module counts only together with a new row of readings in
``PERF.md``: an edit here changes every figure read through it.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time

import torch

from burn_raymarching_tpu_torch.utils.profiling import WINDOW_MARGIN_S

# The __global__ functions under csrc/, as a trace names them.
HAND_KERNELS = ("march_shade_kernel", "march_pack_kernel",
                "culled_march_kernel", "shade_pack_kernel",
                "shade_fwd_kernel", "shade_bwd_kernel", "rep_fwd_kernel",
                "rep_bwd_kernel", "ctail_fwd_kernel", "ctail_bwd_kernel",
                "tile_select_kernel")


# Host calls that put work on a stream, as the trace names them.
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync",
                "cuMemcpy", "cuMemset")


def profile_calls(one, steps: int, margin_s: float = WINDOW_MARGIN_S,
                  steps_per_call: int = 1) -> dict:
    """torch.profiler over ``one(0)`` .. ``one(steps - 1)``, read from its
    trace's device events (kernels, copies, memsets; not the annotation
    spans that the trace also places on the device) → busy device time per
    step (the union of their intervals), events per step, the five kernel
    names with the most device time, the device time of each hand-written
    kernel (HAND_KERNELS) that ran and its events in the window, the
    device time of the NCCL kernels (names holding "nccl"), and the
    host's launch calls per step (LAUNCH_CALLS among the runtime and driver
    calls). The window stays open ``margin_s`` on each side of the calls:
    torch.profiler drops device events stamped before it opens
    (utils/profiling.trace). When each ``one(s)`` runs ``steps_per_call``
    training steps (a replay of a graph of several steps), the per-step
    figures are per training step: each is divided by it as well."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for s in range(steps):
            one(s)
        torch.cuda.synchronize()
        time.sleep(margin_s)
    steps *= steps_per_call
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "")) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    launches = sum(1 for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and any(c in e.get("name", "") for c in LAUNCH_CALLS))
    graph_launches = sum(1 for e in events
                         if e.get("cat") in ("cuda_runtime", "cuda_driver")
                         and "GraphLaunch" in e.get("name", ""))
    busy_us, end = 0.0, -math.inf
    by_name: dict = {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    hand = {k: sum(d for name, d in by_name.items() if k in name)
            for k in HAND_KERNELS}
    hand_events = {k: sum(1 for _, _, name in spans if k in name)
                   for k in HAND_KERNELS}
    nccl = sum(d for name, d in by_name.items() if "nccl" in name.lower())
    return {"device_busy_ms_per_step": busy_us / 1000.0 / steps,
            "device_events_per_step": len(spans) / steps,
            "host_launches_per_step": launches / steps,
            "graph_launches_per_step": graph_launches / steps,
            "nccl_ms_per_step": nccl / 1000.0 / steps,
            "top_kernels_ms_per_step": [[k[:60], d / 1000.0 / steps]
                                        for k, d in top],
            "hand_kernels_ms_per_step": {k: d / 1000.0 / steps
                                         for k, d in hand.items() if d > 0},
            "hand_kernel_events": {k: n for k, n in hand_events.items()
                                   if n > 0}}


def chained_ms(fn, calls: int, per_graph: int = 0, reps: int = 3) -> float:
    """Device ms per call of ``calls`` chained calls of ``fn()``, as a
    ``lax.scan`` over them times it: ``per_graph`` calls (all of them by
    default) are captured into one CUDA graph, which is replayed
    ``calls / per_graph`` times between CUDA events; one warm replay, then
    the best of ``reps``. Calls on one stream run one after another, so
    each waits for the last. The kernel launch counters count what every
    replay launches, as train/chunk.py counts them: the capture's launches
    are taken off and each replay adds them."""
    from burn_raymarching_tpu_torch.ops.cuda import build

    per_graph = per_graph or calls
    if calls % per_graph:
        raise ValueError(f"{calls} calls do not divide into graphs of "
                         f"{per_graph}")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = build.launch_counts()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per_graph):
            fn()
    after = build.launch_counts()
    per_replay = {f: after[f] - before[f] for f in after
                  if after[f] != before[f]}
    for f, d in per_replay.items():
        f.launches -= d

    def run() -> None:
        for _ in range(calls // per_graph):
            graph.replay()
            for f, d in per_replay.items():
                f.launches += d

    run()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best

"""The device-time yardstick of the port's measurements: torch.profiler's
trace of a few calls, read as the device-busy time per call (the union of
the kernel, copy and memset intervals), the device events per call, the
kernels with the most device time, each hand-written kernel's share, and
the launches the host made per call (kernel launches, copies, memsets and
CUDA-graph launches, each one runtime or driver call). Kernels that a
CUDA-graph replay runs appear as device events like any other.

``chip_smoke.py`` (its config-1, config-4, refine and config-5 phases),
``tools/bench_large.py`` and ``tools/bench.py`` report these numbers, and
``PERF.md`` compares them across PRs. Change what this module counts only together with a new
row of readings in ``PERF.md``: an edit here changes every figure read
through it.
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
                "rep_bwd_kernel")


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

"""The device-time yardstick of the port's measurements: torch.profiler's
trace of a few calls, read as the device-busy time per call (the union of
the kernel, copy and memset intervals), the device events per call, the
kernels with the most device time and each hand-written kernel's share.

``chip_smoke.py`` (its config-1, config-4, refine and config-5 phases) and
``tools/bench_large.py`` report these numbers, and ``PERF.md`` compares
them across PRs. Change what this module counts only together with a new
row of readings in ``PERF.md``: an edit here changes every figure read
through it.
"""

from __future__ import annotations

import json
import math
import os
import tempfile

import torch

# The __global__ functions under csrc/, as a trace names them.
HAND_KERNELS = ("march_shade_kernel", "march_pack_kernel",
                "culled_march_kernel", "shade_pack_kernel",
                "shade_fwd_kernel", "shade_bwd_kernel", "rep_fwd_kernel",
                "rep_bwd_kernel")


def profile_calls(one, steps: int) -> dict:
    """torch.profiler over ``one(0)`` .. ``one(steps - 1)``, read from its
    trace's device events (kernels, copies, memsets; not the annotation
    spans that the trace also places on the device) → busy device time per
    step (the union of their intervals), events per step, the five kernel
    names with the most device time, and the device time of each
    hand-written kernel (HAND_KERNELS) that ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(steps):
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

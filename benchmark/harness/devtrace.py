"""Spans and the device trace: how the per-layer metrics are read.

Spans are the benchmark's own: it wraps the calls into each layer of the
program on the instance it drives, and records each call's name, start and
end on the host clock. In the traced run a span also opens a
``record_function`` range named ``bench.<name>`` (so the trace shows which
layer the host was in) and ends after ``torch.cuda.synchronize()``, so that
the device work the call enqueued falls inside it.

The trace is torch.profiler over a slice of the window (the traffic file
says which steps or frames), read from its exported events as
the program's ``tools/device_time.profile_calls`` reads them (a copy of its
arithmetic, so that a later change to the program cannot move this one):
busy time is the union of the kernel, copy and memset intervals; host
launch calls are the runtime and driver calls named in ``LAUNCH_CALLS``.
The profiler drops device events stamped before it opens, so the slice is
marked by its own ``bench.slice`` range, opened ``MARGIN_S`` after the
profiler and closed ``MARGIN_S`` before it stops.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import time

import torch

MARGIN_S = 0.01
HAND_KERNELS = {
    "K1": ("march_shade_kernel", "march_pack_kernel"),
    "K2": ("shade_pack_kernel", "shade_fwd_kernel", "shade_bwd_kernel"),
    "K3": ("culled_march_kernel",),
    "K4": ("rep_fwd_kernel", "rep_bwd_kernel"),
}
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync",
                "cuMemcpy", "cuMemset")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock spans of the layers the harness calls into."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str, annotate: bool = True):
        """A span of ``name``; ``annotate=False`` leaves the trace range
        out (the harness's own pauses, which start or stop the
        profiler)."""
        if not self.traced:
            yield
            return
        t0 = time.perf_counter()
        rng = (torch.profiler.record_function("bench." + name) if annotate
               else contextlib.nullcontext())
        with rng:
            try:
                yield
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.items.append((name, t0, time.perf_counter()))

    def wrap(self, obj, method: str, name: str) -> None:
        """Route ``obj.method`` through a span of ``name`` (on the
        instance; a traced run only)."""
        if not self.traced or not hasattr(obj, method):
            return
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, method, wrapped)

    def seconds(self, name: str, lo: float, hi: float) -> float:
        """Host seconds inside [lo, hi] covered by spans called ``name``."""
        return union_us((max(a, lo), min(b, hi), n) for n, a, b in self.items
                        if n == name and min(b, hi) > max(a, lo))


class Slice:
    """torch.profiler over part of the window."""

    def __init__(self):
        self.prof = None
        self.range = None
        self.t0 = self.t1 = None
        self.events = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(MARGIN_S)
        self.range = torch.profiler.record_function("bench.slice")
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.range.__exit__(None, None, None)
        time.sleep(MARGIN_S)
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)["traceEvents"]
        self.prof = None
        self.events = Events(raw)


class Events:
    """The parts of a trace the readers use, in the trace's microseconds."""

    def __init__(self, raw: list):
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", "")) for e in raw
            if e.get("cat") in DEVICE_CATS and "dur" in e)
        self.ranges = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"][len("bench."):]) for e in raw
            if e.get("cat") == "user_annotation" and "dur" in e
            and str(e.get("name", "")).startswith("bench."))
        self.launches = sorted(
            float(e["ts"]) for e in raw
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and any(c in e.get("name", "") for c in LAUNCH_CALLS))
        (sl,) = [r for r in self.ranges if r[2] == "slice"] or [
            (min(x[0] for x in self.device), max(x[1] for x in self.device),
             "slice")]
        self.lo, self.hi = sl[0], sl[1]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def clipped(self, lo=None, hi=None):
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        for a, b, name in self.device:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                yield a, b, name

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or memset ran in the slice."""
        return union_us(self.clipped()) / 1e6

    def intervals(self, name: str) -> list[tuple[float, float]]:
        """The ``bench.<name>`` ranges inside the slice."""
        return [(max(a, self.lo), min(b, self.hi)) for a, b, n in self.ranges
                if n == name and b > self.lo and a < self.hi]

    def inside(self, name: str):
        """Device events that start inside a ``bench.<name>`` range."""
        iv = self.intervals(name)
        out = []
        j = 0
        for a, b, n in self.device:
            while j < len(iv) and iv[j][1] < a:
                j += 1
            if j < len(iv) and iv[j][0] <= a <= iv[j][1]:
                out.append((a, b, n))
        return out

    def kernel_s(self, names, within: str | None = None) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names`` (in the slice, or starting inside ``within`` ranges)."""
        evs = self.inside(within) if within else list(self.clipped())
        return sum(b - a for a, b, n in evs
                   if any(k in n for k in names)) / 1e6

    def launches_in_slice(self) -> int:
        return sum(1 for t in self.launches if self.lo <= t <= self.hi)

    def top_ops(self, count: int = 10) -> list:
        by: dict = {}
        for a, b, n in self.clipped():
            by[n[:60]] = by.get(n[:60], 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> list:
        """The longest gaps between device work in the slice, each named
        by the innermost harness range open at its middle."""
        gaps, end = [], self.lo
        for a, b, _ in self.clipped():
            if a > end:
                gaps.append((a - end, end, a))
            end = max(end, b)
        if self.hi > end:
            gaps.append((self.hi - end, end, self.hi))
        out = []
        for dur, a, b in sorted(gaps, reverse=True)[:count]:
            mid = 0.5 * (a + b)
            open_ = [r for r in self.ranges
                     if r[0] <= mid <= r[1] and r[2] != "slice"]
            label = (min(open_, key=lambda r: r[1] - r[0])[2] if open_
                     else "outside")
            out.append([label, dur / 1e6])
        return out


def union_us(intervals) -> float:
    total, end = 0.0, -math.inf
    for a, b, _ in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total

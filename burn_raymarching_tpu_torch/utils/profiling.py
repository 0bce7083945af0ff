"""Tracing / profiling / debug utilities (port of
burn_raymarching_tpu/utils/profiling.py, which wraps ``jax.profiler``).

  * ``trace(logdir)`` — torch.profiler over a region, CPU activity plus the
    CUDA activity when the process has a card; writes a Chrome trace
    ``<logdir>/trace.json`` (open with Perfetto or chrome://tracing);
  * ``annotate(name, **attrs)`` — the program's span. Off by default; with
    ``TRACER.enable()`` each span is kept in memory (name, parent, host
    clock, attributes); while a torch.profiler records, each opens a
    ``record_function`` range ``prog.<name>``, so that the trace shows the
    program's layers on the device events' clock. ``TRACER`` also keeps the
    program's counters and, at each CUDA graph capture, the capture's
    phase map, which ``attribute`` uses to put a replay's device events
    down to the step's phases; ``TRACER.records()`` / ``dump(path)`` hand
    them out;
  * ``debug_mode()`` — raise on the first operator whose floating output
    holds a NaN, forward and backward (the analog of ``jax_debug_nans``).

``tools/device_time.py`` is the port's device-time yardstick for PERF.md;
this module is the general-purpose counterpart of the JAX package's and
does not replace it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import json
import os
import threading
import time
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# torch.profiler keeps a device event only if its timestamp, converted to
# the host's clock, lies between start() and stop(). On an H100 that
# conversion has run milliseconds early in some regions, so a region that
# began right after start() lost its first kernels (tools/trace_window.py
# counts them); the window is held open this long on each side of the region.
WINDOW_MARGIN_S = 0.01


@contextlib.contextmanager
def trace(logdir: str, margin_s: float = WINDOW_MARGIN_S):
    """Profile a region: ``with trace('/tmp/trace'): step(...)``. Yields
    the ``torch.profiler.profile`` object; ``<logdir>/trace.json`` is
    written when the region ends, also when it raises. With a card the
    profiler starts ``margin_s`` before the region and stops ``margin_s``
    after its device work has ended."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    if cuda:
        time.sleep(margin_s)
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(margin_s)
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class annotate:
    """The program's span ``name``: ``with annotate("trainer.stage",
    stage=s) as attrs:`` (the body may add to ``attrs``).

    With the tracer on, the span is kept in ``TRACER`` (its id, its
    parent's id, its name, ``time.perf_counter()`` at start and end, the
    attributes). While a torch.profiler records, on or off, it opens a
    ``record_function`` range ``prog.<name>``, so that the trace holds the
    span on the device events' clock (a range costs tens of µs and shows
    nowhere else). Off and unprofiled it keeps and opens nothing. It never
    synchronises the device."""

    __slots__ = ("name", "attrs", "_rec", "_state", "_range")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> dict:
        if TRACER.on:
            th = self._state = TRACER._thread()
            st = th.stack
            if th.capture is not None:
                th.capture.mark(st[-1][_NAME] if st else None)
            self._rec = [next(TRACER._ids), st[-1][_ID] if st else None,
                         self.name, self.attrs, time.perf_counter(), None]
            st.append(self._rec)
        else:
            self._rec = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function("prog." + self.name)
            self._range.__enter__()
        else:
            self._range = None
        return self.attrs

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        rec = self._rec
        if rec is not None:
            rec[_T1] = time.perf_counter()
            th = self._state
            if th.capture is not None:
                th.capture.mark(rec[_NAME])
            st = th.stack
            if st and st[-1] is rec:
                st.pop()
            elif rec in st:
                del st[st.index(rec):]
            TRACER._done.append(rec)
        return False


# A kept span: [id, parent id, name, attributes, start, end].
_ID, _PARENT, _NAME, _ATTRS, _T0, _T1 = range(6)
_SPAN_KEYS = ("id", "parent", "name", "attrs", "t0", "t1")


# CUgraphNodeType values whose nodes a profiler trace shows as one device
# event each (a kernel, a copy, a memset).
_EVENT_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1        # CU_STREAM_CAPTURE_STATUS_ACTIVE


@functools.cache
def _libcuda() -> ctypes.CDLL:
    """libcuda's graph queries, through ctypes."""
    lib = ctypes.CDLL("libcuda.so.1")
    vp, size = ctypes.c_void_p, ctypes.c_size_t
    for fn, args in (
            ("cuStreamGetCaptureInfo_v2",
             [vp, ctypes.POINTER(ctypes.c_int),
              ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(vp),
              ctypes.POINTER(ctypes.POINTER(vp)), ctypes.POINTER(size)]),
            ("cuGraphGetNodes", [vp, ctypes.POINTER(vp),
                                 ctypes.POINTER(size)]),
            ("cuGraphNodeGetType", [vp, ctypes.POINTER(ctypes.c_int)])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _graph_nodes(stream: torch.cuda.Stream) -> Callable[[], dict]:
    """A function that returns {node: CUgraphNodeType} of the graph
    ``stream`` is capturing into (the capture must have begun)."""
    lib = _libcuda()
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    err = lib.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), None,
        ctypes.byref(graph), None, None)
    if err or status.value != _CAPTURE_ACTIVE:
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2: error {err}, "
                           f"status {status.value}")
    kinds: dict = {}

    def nodes() -> dict:
        n = ctypes.c_size_t()
        err = lib.cuGraphGetNodes(graph, None, ctypes.byref(n))
        arr = (ctypes.c_void_p * n.value)()
        if not err and n.value:
            err = lib.cuGraphGetNodes(graph, arr, ctypes.byref(n))
        if err:
            raise RuntimeError(f"cuGraphGetNodes: error {err}")
        for node in arr:
            if node not in kinds:
                kind = ctypes.c_int()
                if lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                          ctypes.byref(kind)):
                    raise RuntimeError("cuGraphNodeGetType failed")
                kinds[node] = kind.value
        return kinds

    return nodes


class _PhaseMap:
    """The nodes a capturing graph gains, credited in capture order to the
    span innermost while each was recorded. A query that fails turns the
    map off (``error``); the capture goes on."""

    def __init__(self, nodes: Callable[[], dict]):
        self.nodes = nodes
        self.phases: list[list] = []       # [[phase, device events]]
        self.kinds: collections.Counter = collections.Counter()
        self.per_replay: collections.Counter = collections.Counter()
        self.error: Optional[str] = None
        self._seen: set = set()

    def mark(self, phase: Optional[str]) -> None:
        """Credit the nodes recorded since the last mark to ``phase``."""
        if self.error is not None:
            return
        try:
            now = self.nodes()
        except Exception as err:  # a failed query must not end the capture
            self.error = repr(err)
            return
        events = 0
        for node, kind in now.items():
            if node not in self._seen:
                self._seen.add(node)
                name = _EVENT_NODES.get(kind, "other")
                self.kinds[name] += 1
                events += name != "other"
        if not events:
            return
        phase = phase or "other"
        if self.phases and self.phases[-1][0] == phase:
            self.phases[-1][1] += events
        else:
            self.phases.append([phase, events])


class _ThreadState:
    """One thread's open spans (innermost last) and the capture it is
    recording, if any."""

    __slots__ = ("stack", "capture")

    def __init__(self):
        self.stack: list[dict] = []
        self.capture: Optional[_PhaseMap] = None


class Tracer:
    """The program's spans and counters, kept in memory while on.

    Host counters (``count``): jobs, stages, captures, replays, steps,
    tiles and table slots (tiles × the table width, the culling budget or
    the table's rows where it has fewer), frames by quality, and what
    density control took in, merged, pruned, split and gave out
    (``density.in`` .. ``density.out``, summed over the boundaries). What
    a step counts while a CUDA graph is captured is kept with the capture
    and added once per replay (``replayed``); a graph captured while the
    tracer was off counts only its replays. Device counters
    (``add_valid``): the valid culled-table
    entries the steps select and their tiles that keep a valid slot, an
    int64 pair on the card that a captured step adds into on every replay,
    read once by ``records`` (which reports the second as ``empty_tiles``,
    the tiles that keep none). At each capture
    made while on, the phase map: how many device events (kernel, copy and
    memset nodes) the graph gained in each span, in capture order
    (``attribute`` reads it)."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._valid: dict = {}
        self._capture_ids = itertools.count(1)
        self.captures: list[dict] = []
        self.reset()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        """Forget the spans and counters (the device counters are zeroed in
        place: captured graphs add into them). The capture records stay:
        their graphs may still replay."""
        self._done: list[list] = []
        self.counters: collections.Counter = collections.Counter()
        self._ids = itertools.count()
        for t in self._valid.values():
            t.zero_()

    @contextlib.contextmanager
    def paused(self):
        """The tracer off for a region whose effects are undone after it
        (a capture's warm-up step)."""
        was, self.on = self.on, False
        try:
            yield
        finally:
            self.on = was

    def _thread(self) -> "_ThreadState":
        """This thread's open spans and capture."""
        try:
            return self._local.state
        except AttributeError:
            self._local.state = _ThreadState()
            return self._local.state

    def count(self, name: str, k: int = 1) -> None:
        if not self.on:
            return
        cap = self._thread().capture
        (self.counters if cap is None else cap.per_replay)[name] += k

    def replayed(self, capture_id: Optional[int], replays: int) -> None:
        """``replays`` replays of the graph of ``capture_id``."""
        if not self.on:
            return
        self.counters["replays"] += replays
        for rec in self.captures:
            if rec["id"] == capture_id:
                for name, k in rec["per_replay"].items():
                    self.counters[name] += k * replays

    def device_counter(self, device) -> torch.Tensor:
        """The int64 pair on ``device`` that steps add into: their valid
        table entries, and their tiles that keep a valid slot; a capture
        makes it before it begins, so that the graph adds into it."""
        key = str(torch.device(device))
        if key not in self._valid:
            self._valid[key] = torch.zeros(2, dtype=torch.int64,
                                           device=device)
        return self._valid[key]

    def add_valid(self, valid: torch.Tensor) -> None:
        """Add a step's selection ``valid`` [tiles, K] to the device
        counters: its true entries, and its tiles whose first slot is valid.
        Every selection keeps a tile's valid slots first, so those are the
        tiles that keep any."""
        if not self.on:
            return
        if (str(valid.device) not in self._valid and valid.is_cuda
                and torch.cuda.is_current_stream_capturing()):
            return  # made inside a capture, each replay would zero it
        counter = self.device_counter(valid.device)
        counter[0].add_(valid.sum())
        counter[1].add_(valid[:, 0].sum())

    @contextlib.contextmanager
    def capture(self, stream, nodes: Optional[Callable[[], dict]] = None):
        """Inside ``torch.cuda.graph(graph, stream=stream)``: record the
        capture's phase map and what one replay counts → yields the
        capture's id (None with the tracer off). ``nodes`` replaces the
        node list libcuda gives (tests)."""
        if not self.on:
            yield None
            return
        cid = next(self._capture_ids)
        self.counters["captures"] += 1
        try:
            pm = _PhaseMap(nodes or _graph_nodes(stream))
        except Exception as err:  # no map, but the capture goes on
            pm = _PhaseMap(dict)
            pm.error = repr(err)
        th = self._thread()
        th.capture = pm
        try:
            yield cid
        finally:
            pm.mark(th.stack[-1][_NAME] if th.stack else None)
            th.capture = None
            self.captures.append({
                "id": cid, "phases": pm.phases, "nodes": dict(pm.kinds),
                "per_replay": dict(pm.per_replay), "error": pm.error})

    def records(self) -> dict:
        """What was kept: spans, counters (with ``valid_entries`` and
        ``empty_tiles``, the counted tiles less those that keep a valid
        slot, read from the device once, when steps have counted table
        slots) and captures."""
        counters = dict(self.counters)
        if counters.get("table_slots"):
            totals = [sum(int(t[i]) for t in self._valid.values())
                      for i in range(2)]
            counters["valid_entries"] = totals[0]
            counters["empty_tiles"] = counters.get("tiles", 0) - totals[1]
        return {"spans": [dict(zip(_SPAN_KEYS, s)) for s in self._done],
                "counters": counters,
                "captures": [dict(c) for c in self.captures]}

    def dump(self, path: str) -> None:
        """``records()`` as JSON at ``path``."""
        with open(path, "w") as f:
            json.dump(self.records(), f)


TRACER = Tracer()


def self_seconds(spans: list[dict]) -> dict:
    """Each span's self time: its duration less its children's → {id: s}."""
    out = {s["id"]: s["t1"] - s["t0"] for s in spans}
    for s in spans:
        if s["parent"] in out:
            out[s["parent"]] -= s["t1"] - s["t0"]
    return out


def attribute(events: list, phases: list) -> Optional[list]:
    """The phase of each device event of one replay of a captured graph.
    ``events`` are the replay's events in start order (in a profiler trace,
    those whose correlation id is the replay's ``cudaGraphLaunch``),
    ``phases`` the capture's map (``[phase, events]`` in capture order): a
    graph captured on one stream runs its nodes in capture order. → one
    phase per event, or None when the count differs from the map's total:
    such a replay is not attributed (nothing is guessed)."""
    if len(events) != sum(n for _, n in phases):
        return None
    return [name for name, n in phases for _ in range(n)]


def phase_seconds(replays: list, phases: list) -> dict:
    """Device seconds by phase over ``replays`` (each a list of (start_us,
    end_us, name) events in start order) → {"phases": {phase: s},
    "replays": the replays attributed, "unattributed_s": the device
    seconds of the replays left out}."""
    by: collections.Counter = collections.Counter()
    out = {"replays": 0, "unattributed_s": 0.0}
    for events in replays:
        names = attribute(events, phases)
        if names is None:
            out["unattributed_s"] += sum(b - a for a, b, _ in events) / 1e6
            continue
        out["replays"] += 1
        for (a, b, _), name in zip(events, names):
            by[name] += (b - a) / 1e6
    out["phases"] = dict(by)
    return out


_aten = torch.ops.aten
# Factories whose outputs are uninitialised memory: a NaN there is not
# produced by any arithmetic.
_UNINITIALISED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


class _NanCheck(TorchDispatchMode):
    """Raise FloatingPointError on the first operator whose floating-point
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALISED:
            return out
        for leaf in tree_leaves(out):
            if (isinstance(leaf, torch.Tensor)
                    and (leaf.is_floating_point() or leaf.is_complex())
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (debug_mode)")
        return out


@contextlib.contextmanager
def debug_mode():
    """NaN-checking context: every PyTorch operator run inside it, forward
    or backward, raises FloatingPointError naming itself when a floating
    output holds a NaN (as ``jax_debug_nans`` does); autograd's anomaly
    mode is on as well, so a backward failure names the forward operator
    that recorded it. The hand-written CUDA kernels launch through ctypes,
    outside PyTorch's dispatcher: their outputs are not checked here."""
    with torch.autograd.set_detect_anomaly(True), _NanCheck():
        yield

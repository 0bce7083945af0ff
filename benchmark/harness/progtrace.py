"""The program's own spans and counters, as the per-layer metrics read them.

In a traced run the program's tracer is on from the command's start
(``harness/__init__.py``), and the readers take its records in-process
after the run (``TRACER.records()``, read once). A program without the
tracer gives no records, and every reader here then returns None (a traced
run says so once on standard error).

* Window shares: host seconds of one program span inside the run's window,
  over the window less the harness's own pauses (as ``boundary_share``).
* Phase times: device seconds of each phase of the captured step per step
  replayed in the traced slice. A replay's events carry no host range in
  the trace, and this harness keeps no correlation ids, so the replays are
  found by their events: the program's ``trainer.replay`` spans between
  the harness's pauses say how many replays of which capture the slice
  ran, in order; each capture's replay (its prologue and the events its
  phase map counts) is learnt from a stretch where it repeats, and found
  where it occurs. No clock is compared: which events are a replay's is
  decided by their names and order alone. Replays that do not occur as
  the program ran them (one that lost, gained or changed an event) are
  left out, never guessed, and each counts as the median device time of
  the capture's replays found; past 1% of the replays' device time the
  reader returns None. This matcher (``_periodic_runs``,
  ``_replay_blocks``, ``_find_blocks``, ``MAX_PROLOGUE`` and the grouping
  in ``_phase_times``) goes once the harness keeps each device event's
  correlation id: the replays are then grouped by their
  ``cudaGraphLaunch`` and ``profiling.attribute`` is called on each
  (PERF.md, §7).
"""

from __future__ import annotations

import bisect
import json
import statistics
import sys

UNATTRIBUTED_MAX = 0.01
# The most events a replay launches before its graph (torch's replay
# prologue writes each registered generator's seed and offset).
MAX_PROLOGUE = 8
_cache: dict = {}


def records(run) -> dict | None:
    """The program's records of this run: ``run.program`` where the run
    carries them (tests), else the program's tracer's, read once."""
    if getattr(run, "program", None) is not None:
        return run.program
    if "records" not in _cache:
        try:
            from burn_raymarching_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        tracer = getattr(profiling, "TRACER", None)
        got = tracer.records() if tracer is not None else None
        _cache["records"] = got if got and got["spans"] else None
        if _cache["records"] is None:
            print("progtrace: the traced run found no program records (a "
                  "program without the tracer, or a run that did not switch "
                  "it on: harness/__init__.py does for `benchmark/run.py "
                  "... --trace 1`); the program's per-layer metrics are "
                  "left out", file=sys.stderr, flush=True)
    return _cache["records"]


def spans(run, name: str) -> list[dict]:
    rec = records(run)
    return [] if rec is None else [s for s in rec["spans"]
                                   if s["name"] == name]


def window_share(run, name: str) -> float | None:
    """% of the run's window (less the harness's pauses) that the host
    spent in the program's ``name`` spans."""
    if records(run) is None:
        return None
    lo, hi = run.window
    total = (hi - lo) - run.spans.seconds("pause", lo, hi)
    if total <= 0:
        return None
    inside = sorted((max(s["t0"], lo), min(s["t1"], hi))
                    for s in spans(run, name)
                    if s["t1"] is not None and min(s["t1"], hi)
                    > max(s["t0"], lo))
    covered, end = 0.0, float("-inf")
    for a, b in inside:
        covered += max(0.0, b - max(a, end))
        end = max(end, b)
    return 100.0 * covered / total


def _slice_runs(run, rec) -> list[dict]:
    """The program's ``trainer.replay`` spans (one per ``ChunkRunner.run``)
    inside the traced slice, from the harness's pauses that start and stop
    the profiler."""
    pauses = sorted((a, b) for n, a, b in run.spans.items if n == "pause")
    if not pauses:
        return []
    lo = pauses[0][1]
    hi = pauses[1][0] if len(pauses) > 1 else float("inf")
    return sorted((s for s in rec["spans"] if s["name"] == "trainer.replay"
                   and lo <= s["t0"] and s["t1"] <= hi),
                  key=lambda s: s["t0"])


def _periodic_runs(names: list, period: int) -> list[tuple[int, int]]:
    """Maximal stretches (start, length) of at least two periods in which
    every name equals the name ``period`` later."""
    out, start = [], None
    for i in range(len(names) - period + 1):
        same = i < len(names) - period and names[i] == names[i + period]
        if same and start is None:
            start = i
        elif not same and start is not None:
            if i - start >= period:
                out.append((start, i - start + period))
            start = None
    return out


def _stretches(names: list, cache: dict, length: int, r: int, cursor: int):
    """Stretches (start, length, period) from ``cursor`` on that may hold a
    run of ``r`` replays of a graph of ``length`` events: those of ``r``
    periods first, then those of 2 to ``r`` - 1 (a run in which a replay
    differs)."""
    for whole in (True, False):
        for period in range(length + 1, length + MAX_PROLOGUE + 1):
            if period not in cache:
                cache[period] = _periodic_runs(names, period)
            for a, n in cache[period]:
                k = n // period
                if a >= cursor and (k == r if whole else 2 <= k < r):
                    yield a, n, period


def _replay_blocks(names: list, runs: list, caps: dict) -> dict:
    """{capture id: the names of one replay in the device stream}: the few
    events each replay launches before its graph (torch's replay
    prologue: one fill for each registered generator's seed and one for
    its offset, the same kernel), then the graph's events, as many as its
    phase map counts. Each ``run`` of two or more replays, in order, holds
    a stretch of the stream where the same block repeats (``_stretches``);
    a stretch may hold a few more events at its ends that happen to
    continue the period, so its candidates are each of its alignments, and
    the block is the one that starts with a prologue of one kernel. A
    capture whose runs give no block, or two different ones, has none."""
    stretches: dict = {}
    blocks: dict = {}
    cursor = 0
    for span in runs:
        cid, r = span["attrs"].get("capture"), span["attrs"].get("replays", 0)
        cap = caps.get(cid)
        if cap is None or r < 2:
            continue
        length = sum(k for _, k in cap["phases"])
        for a, n, period in _stretches(names, stretches, length, r, cursor):
            pro = period - length
            cands = [c for c in {tuple(names[a + k:a + k + period])
                                 for k in range(n % period + 1)}
                     if len(set(c[:pro])) == 1 and c[pro] != c[0]]
            if len(cands) == 1:
                cursor = a + n
                blocks[cid] = (cands[0] if blocks.get(cid, cands[0])
                               == cands[0] else None)
                break
    return blocks


def _find_blocks(names: list, block: list) -> list[int]:
    """Start indices of the non-overlapping occurrences of ``block``."""
    out, i, n = [], 0, len(block)
    while i <= len(names) - n:
        if names[i] == block[0] and names[i:i + n] == block:
            out.append(i)
            i += n
        else:
            i += 1
    return out


def phase_times(run) -> dict | None:
    """{"phases": {phase: device s}, "steps": steps attributed,
    "replays", "unattributed": replays left out, "replay_s": the replays'
    device s, "unattributed_s": the part of it left out} over the traced
    slice's replays, or None without records or with over 1% of the
    replays' device time left out."""
    if not hasattr(run, "program_phases"):
        run.program_phases = _phase_times(run)
    return run.program_phases


def _phase_times(run) -> dict | None:
    rec = records(run)
    if rec is None or run.events is None:
        return None
    from burn_raymarching_tpu_torch.utils.profiling import phase_seconds

    evs = list(run.events.clipped())
    names = [e[2] for e in evs]
    caps = {c["id"]: c for c in rec["captures"]}
    runs = _slice_runs(run, rec)
    blocks = _replay_blocks(names, runs, caps)
    # Captures whose replays have the same names (one step at one size)
    # are counted together, if their phase maps agree.
    groups: dict = {}
    for span in runs:
        cid = span["attrs"].get("capture")
        block = blocks.get(cid)
        g = groups.setdefault(block, {"n": 0, "maps": set()})
        g["n"] += span["attrs"].get("replays", 0)
        if cid in caps:
            g["maps"].add(json.dumps([caps[cid]["phases"],
                                      caps[cid]["per_replay"]]))
    total = {"phases": {}, "steps": 0,
             "replays": sum(g["n"] for g in groups.values()),
             "unattributed": 0, "replay_s": 0.0, "unattributed_s": 0.0}
    for block, g in groups.items():
        starts = (_find_blocks(names, list(block))
                  if block and len(g["maps"]) == 1 else [])
        if not starts:
            return None     # no replay of it to measure the rest by
        phases, per_replay = json.loads(g["maps"].pop())
        skip = len(block) - sum(k for _, k in phases)
        graph = [evs[i + skip:i + len(block)] for i in starts]
        each = statistics.median(sum(b - a for a, b, _ in r) / 1e6
                                 for r in graph)
        if len(starts) > g["n"]:
            # More occurrences than replays: which are the replays is not
            # known, so none is attributed.
            total["unattributed"] += g["n"]
            total["unattributed_s"] += g["n"] * each
            total["replay_s"] += g["n"] * each
            continue
        got = phase_seconds(graph, phases)
        for k, v in got["phases"].items():
            total["phases"][k] = total["phases"].get(k, 0.0) + v
        left = g["n"] - got["replays"]
        left_s = (g["n"] - len(starts)) * each + got["unattributed_s"]
        total["steps"] += got["replays"] * per_replay.get("steps", 0)
        total["unattributed"] += left
        total["unattributed_s"] += left_s
        total["replay_s"] += sum(got["phases"].values()) + left_s
    if (not total["steps"] or total["unattributed_s"]
            > UNATTRIBUTED_MAX * total["replay_s"]):
        return None
    return total


def phase_ms_per_step(run, phase: str) -> float | None:
    """Device ms of the captured step's ``phase`` per replayed step."""
    got = phase_times(run)
    if got is None:
        return None
    return 1000.0 * got["phases"].get(phase, 0.0) / got["steps"]


def cull_fill(run) -> float | None:
    """% of the culled tables' slots that hold a valid entry, over every
    step counted since the tracer was switched on: set-up's checked steps
    and every job of the run, not the window's steps alone (the counters
    are read once, at the end; reading them over the window needs the
    harness to snapshot or reset them at the window's start). So a longer
    window, whose later stages' tables fill less, reads lower."""
    rec = records(run)
    if rec is None:
        return None
    c = rec["counters"]
    if not c.get("table_slots") or "valid_entries" not in c:
        return None
    return 100.0 * c["valid_entries"] / c["table_slots"]


def job_start_s(run) -> float | None:
    """Median over the jobs that start in the run's window of the seconds
    from a job's ``trainer.run`` to its first ``trainer.replay``."""
    lo, hi = getattr(run, "window", (float("-inf"), float("inf")))
    runs = sorted(s["t0"] for s in spans(run, "trainer.run"))
    replays = sorted(s["t0"] for s in spans(run, "trainer.replay"))
    waits = []
    for k, t in enumerate(runs):
        end = runs[k + 1] if k + 1 < len(runs) else float("inf")
        first = replays[bisect.bisect_left(replays, t):][:1]
        if lo <= t <= hi and first and first[0] < end:
            waits.append(first[0] - t)
    return statistics.median(waits) if waits else None


def frame_child_ms(run, child: str, quality: str = "low") -> float | None:
    """Median ms of the ``child`` span of the viewer's frames of
    ``quality``."""
    rec = records(run)
    if rec is None:
        return None
    frames = {s["id"] for s in rec["spans"] if s["name"] == "view.frame"
              and s["attrs"].get("quality") == quality}
    ms = [1000.0 * (s["t1"] - s["t0"]) for s in rec["spans"]
          if s["name"] == child and s["parent"] in frames]
    return statistics.median(ms) if ms else None

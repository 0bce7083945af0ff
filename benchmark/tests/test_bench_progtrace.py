"""The readers of the program's spans and counters (harness/progtrace.py
and the metrics that use it) on a synthetic traced run: window shares,
the captured step's phase times found in a device stream that holds no
host range inside a replay (the captures' warm-up steps, the reads
between replays and each replay's prologue left out; replays that do not
occur as often as the program ran them left out, and the reading refused
past 1% of the replays' device time), the culled tables' fill, the jobs' start and the viewer
frame's children; and nothing read from a program without the tracer."""

import types

import pytest

from benchmark.harness import devtrace, progtrace
from benchmark.harness.manifest import metric_reader

GRAPH = ["add", "gather", "select", "k3", "tail", "Memset (Device)",
         "bwd", "Memcpy DtoD (Device -> Device)", "adam"]
PHASES = [["step.sample", 2], ["step.select", 1], ["step.march", 1],
          ["step.tail", 1], ["step.backward", 3], ["step.adam", 1]]
NODES = {"kernel": 7, "memcpy": 1, "memset": 1, "other": 2}


def span(i, name, t0, t1, parent=None, **attrs):
    return {"id": i, "parent": parent, "name": name, "t0": t0, "t1": t1,
            "attrs": attrs}


def kernels(names, t0, dur=1.0):
    """Back-to-back device events from ``t0`` (µs), ``dur`` each."""
    return [{"cat": "kernel", "ts": t0 + i * dur, "dur": dur, "name": n}
            for i, n in enumerate(names)]


def rng(name, a, b):
    return {"cat": "user_annotation", "ts": a, "dur": b - a,
            "name": "bench." + name}


def traced_run(segments, extra_spans=()):
    """A run whose slice holds each segment's device events in order
    (names, 1 µs each, back to back; the trace's clock is the host's in
    µs). ``(names, (capture, replays))`` is one ``ChunkRunner.run``'s
    replays: its ``trainer.replay`` span starts just before its first
    event, inside a harness ``chunk`` range that ends after its last.
    ``(names, "chunk")`` is device work in the next run's chunk range
    before its span (a capture's warm-up), ``(names, None)`` work outside
    any."""
    raw, prog = [rng("slice", 1e6, 50e6)], []
    t, chunk0 = 1e6 + 100.0, None
    for j, (names, what) in enumerate(segments):
        if what == "chunk":
            chunk0 = t - 2
        elif what is not None:
            c, r = what
            prog.append(span(100 + j, "trainer.replay", t * 1e-6,
                             (t + 1) * 1e-6, capture=c, replays=r))
            raw.append(rng("chunk", t - 2 if chunk0 is None else chunk0,
                           t + 1 + len(names) + 2))
            chunk0 = None
            t += 1
        raw += kernels(names, t)
        # 30 ms to the next segment.
        t += len(names) + 30e3
    sp = devtrace.Spans(True)
    sp.items += [("pause", 0.0, 1.0), ("pause", 50.0, 51.0)]
    # The harness's chunk spans on the host's clock, 3 µs before their
    # ranges on the trace's.
    sp.items += [("chunk", (a["ts"] - 3) * 1e-6,
                  (a["ts"] + a["dur"] - 3) * 1e-6) for a in raw
                 if a["name"] == "bench.chunk"]
    run = types.SimpleNamespace(
        spans=sp, window=(0.0, 60.0), events=devtrace.Events(raw))
    run.program = {"spans": prog + list(extra_spans), "counters": {},
                   "captures": [
                       {"id": 1, "phases": PHASES, "nodes": NODES,
                        "per_replay": {"steps": 1}, "error": None},
                       {"id": 2, "phases": OTHER, "nodes": NODES,
                        "per_replay": {"steps": 1}, "error": None}]}
    return run


PROLOGUE = ["fill", "fill"]
# Another capture of the same step at another size: other kernels.
OTHER_GRAPH = [n + "_16" for n in GRAPH]
OTHER = PHASES


def replays(n, graph=GRAPH):
    return (PROLOGUE + graph) * n


def test_phase_times_find_every_replay_and_leave_the_rest_out():
    # The capture's warm-up runs the step's kernels eagerly inside the
    # run's chunk range; a boundary's three checked steps are single
    # replays with reads after them; the junk before a run may end like a
    # replay ("adam").
    warm = ["refresh"] + GRAPH + ["restore"]
    reads = ["Memcpy DtoH (Device -> Pageable)", "clone"]
    run = traced_run([
        (["refresh", "adam"], None), (replays(5), (1, 5)), (["read"], None),
        (warm, "chunk"), (replays(1), (1, 1)), (reads, None),
        (replays(1), (1, 1)), (reads, None), (replays(1), (1, 1)),
        (reads, None), (replays(10), (1, 10)), (["read", "adam"], None),
        (replays(4, OTHER_GRAPH), (2, 4))])
    got = progtrace.phase_times(run)
    assert got["steps"] == 22 and got["replays"] == 22
    assert got["unattributed"] == 0
    assert got["replay_s"] == pytest.approx(22 * 9e-6)
    assert got["unattributed_s"] == pytest.approx(0.0, abs=1e-12)
    assert got["phases"] == pytest.approx(
        {p: n * 22 * 1e-6 for p, n in PHASES})
    assert metric_reader("backward_ms_per_step.train")(run) == \
        pytest.approx(3e-3)
    assert metric_reader("select_ms_per_step.train")(run) == \
        pytest.approx(1e-3)
    assert metric_reader("adam_ms_per_step.dense")(run) == \
        pytest.approx(1e-3)


def test_replays_not_found_as_often_as_run_are_left_out():
    # One replay of capture 2 lost an event: it is left out, and counts as
    # the median of the capture's replays found (9 µs of graph events).
    broken = PROLOGUE + OTHER_GRAPH[:-1]
    other = replays(4, OTHER_GRAPH) + broken + replays(5, OTHER_GRAPH)
    run = traced_run([(replays(50), (1, 50)), (other, (2, 10))])
    assert progtrace._phase_times(run) is None       # 9 of 540 µs
    run = traced_run([(replays(1000), (1, 1000)), (other, (2, 10))])
    got = progtrace._phase_times(run)
    assert got["steps"] == 1009 and got["unattributed"] == 1
    assert got["unattributed_s"] == pytest.approx(9e-6)
    assert got["replay_s"] == pytest.approx(1010 * 9e-6)


def test_a_replay_that_gained_an_event_is_left_out():
    # An event inside a run's replays that no replay's map counts: that
    # replay is left out. Device work between runs is no replay's.
    odd = PROLOGUE + GRAPH[:4] + ["stray"] + GRAPH[4:]
    run = traced_run([(replays(60) + odd + replays(139), (1, 200)),
                      (["stray"] * 50, None)])
    got = progtrace._phase_times(run)
    assert got["steps"] == 199 and got["unattributed"] == 1
    assert got["unattributed_s"] == pytest.approx(9e-6)   # under 1%
    run = traced_run([(replays(60) + odd + replays(38), (1, 99)),
                      (replays(2) + odd, (1, 3))])
    assert progtrace._phase_times(run) is None     # 18 of 918 µs


def test_clocks_play_no_part():
    # The same stream with the harness's chunk spans far off the trace's
    # ranges reads the same.
    segs = [(replays(5), (1, 5)), (["read"], None), (replays(7), (1, 7))]
    run = traced_run(segs)
    moved = traced_run(segs)
    moved.spans.items = [(n, a + 0.05, b + 0.05) if n == "chunk"
                         else (n, a, b) for n, a, b in moved.spans.items]
    assert progtrace._phase_times(moved) == progtrace._phase_times(run)


def test_captures_of_one_graph_with_other_maps_are_left_out():
    run = traced_run([(replays(5), (1, 5)), (["read"], None),
                      (replays(5), (2, 5))])
    run.program["captures"][1]["phases"] = [["step.sample", 9]]
    assert progtrace._phase_times(run) is None
    run.program["captures"][1]["phases"] = PHASES    # the same map: shared
    assert progtrace._phase_times(run)["steps"] == 10


def test_window_shares_leave_the_pauses_out():
    run = traced_run([(replays(2), (1, 2))], extra_spans=[
        span(1, "trainer.capture", 10.0, 13.0),
        span(2, "trainer.capture", 58.0, 70.0),      # cut at the window
        span(3, "trainer.preview", 20.0, 21.0)])
    # window 60 s, pauses 2 s: 5 s of capture over 58 s.
    assert metric_reader("capture_share.train")(run) == pytest.approx(
        100 * 5 / 58)
    assert metric_reader("preview_share.dense")(run) == pytest.approx(
        100 * 1 / 58)
    assert metric_reader("prefill_share.train")(run) == 0.0


def test_cull_fill_and_the_jobs_start():
    run = traced_run([(replays(2), (1, 2))], extra_spans=[
        span(1, "trainer.run", -5.0, 0.5),           # set-up's job
        span(2, "trainer.run", 3.0, 30.0),
        span(3, "trainer.run", 31.0, 59.0)])
    run.program["spans"] += [span(4, "trainer.replay", -1.0, -0.9,
                                  capture=1, replays=1),
                             span(5, "trainer.replay", 3.1, 3.2,
                                  capture=1, replays=1),
                             span(6, "trainer.replay", 33.5, 33.6,
                                  capture=1, replays=1)]
    run.program["counters"] = {"table_slots": 4000, "valid_entries": 600}
    assert metric_reader("cull_fill.train")(run) == pytest.approx(15.0)
    # jobs at 3 s (first replay at 3.1 s) and 31 s (33.5 s): median 1.3 s.
    assert metric_reader("job_start_s.train")(run) == pytest.approx(1.3)


def test_frame_children_of_the_previews():
    frames = []
    for k, (q, up) in enumerate([("low", 1.0), ("low", 3.0), ("full", 9.0),
                                 ("low", 2.0)]):
        f = 10 * k
        t = float(k)
        frames += [span(f, "view.frame", t, t + 0.5, quality=q),
                   span(f + 1, "view.scene_upload", t, t + up / 1e3, f),
                   span(f + 2, "view.readback", t + 0.1, t + 0.104, f),
                   span(f + 3, "view.encode", t + 0.2, t + 0.2005, f)]
    run = types.SimpleNamespace(events=None, program={
        "spans": frames, "counters": {}, "captures": []})
    assert metric_reader("upload_ms_per_frame.view")(run) == \
        pytest.approx(2.0)
    assert metric_reader("readback_ms_per_frame.view")(run) == \
        pytest.approx(4.0)
    assert metric_reader("encode_ms_per_frame.view")(run) == \
        pytest.approx(0.5)


def test_without_the_programs_records_every_reader_returns_none(
        monkeypatch):
    run = traced_run([(replays(2), (1, 2))])
    run.program = None
    monkeypatch.setitem(progtrace._cache, "records", None)
    for name in ("capture_share.train", "capture_share.dense",
                 "prefill_share.train", "preview_share.train",
                 "preview_share.dense", "select_ms_per_step.train",
                 "tail_ms_per_step.train", "backward_ms_per_step.train",
                 "backward_ms_per_step.dense", "adam_ms_per_step.train",
                 "adam_ms_per_step.dense", "cull_fill.train",
                 "job_start_s.train", "upload_ms_per_frame.view",
                 "readback_ms_per_frame.view", "encode_ms_per_frame.view"):
        assert metric_reader(name)(run) is None, name


def test_only_a_traced_run_of_the_command_switches_the_tracer_on():
    from benchmark.harness import _traced_command

    cmd = ["/x/benchmark/run.py", "--workload", "c4_knot.train", "--seed",
           "1", "--seconds", "51"]
    assert _traced_command(cmd + ["--trace", "1"])
    assert _traced_command(cmd + ["--trace=1"])
    assert _traced_command(cmd + ["--trace", "01"])     # read as an int
    assert not _traced_command(cmd + ["--trace", "one"])
    assert not _traced_command(cmd + ["--trace", "0"])
    assert not _traced_command(cmd)
    assert not _traced_command(["/x/pytest", "--trace", "1"])

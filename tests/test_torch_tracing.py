"""The program's tracer (utils/profiling: ``annotate``, ``TRACER``, the phase
map and ``attribute``): off it keeps and opens nothing; on, a tiny CPU
training job gives the trainer's span tree and counters, and a viewer
frame its five children. The ``cuda`` tests hold a captured step's phase
map to the device events of its replays in a profiler trace, and show that
a graph captured with the tracer off holds none of its nodes."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from burn_raymarching_tpu_torch.config import DensityConfig, TrainConfig
from burn_raymarching_tpu_torch.utils import profiling
from burn_raymarching_tpu_torch.utils.profiling import TRACER

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "runs", "c4_headline", "scene_c5.json")
TRAINER_SPANS = ("trainer.run", "trainer.init", "trainer.stage",
                 "trainer.cluster_tables", "trainer.loss_read",
                 "trainer.preview", "trainer.density", "trainer.export")
DENSITY_SPANS = ("density.read", "density.host", "density.upload")
STEP_PHASES = ("step.sample", "step.select", "step.march", "step.tail",
               "step.loss", "step.backward", "step.adam")


@pytest.fixture
def tracer():
    """TRACER on and empty for one test, off again after it."""
    TRACER.reset()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.reset()


def _dataset(tmp_path, size=32):
    from burn_raymarching_tpu_torch.tools import generate

    out = str(tmp_path / "data")
    generate.main(["--out", out, "--size", str(size), "--device", "cpu"])
    return out


def _names(spans):
    return [s["name"] for s in spans]


def test_tracer_off_keeps_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    TRACER.reset()
    assert not TRACER.on
    with profiling.annotate("trainer.stage", stage=0) as attrs:
        TRACER.count("steps")
        TRACER.add_valid(torch.ones(4, dtype=torch.bool))
    assert attrs == {"stage": 0}
    assert opened == []
    got = TRACER.records()
    assert got["spans"] == [] and got["counters"] == {}


def test_the_tracer_on_opens_no_range_without_a_profiler(monkeypatch,
                                                          tracer):
    """A range costs tens of µs and shows only in a profiler's trace: the
    tracer keeps its spans without one."""
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.annotate("view.frame"):
        pass
    assert opened == []
    assert _names(tracer.records()["spans"]) == ["view.frame"]


def test_annotate_off_inside_a_trace_keeps_its_range(tmp_path):
    TRACER.reset()
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("view.frame"):
            torch.randn(8, 8).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "prog.view.frame" in names
    assert TRACER.records()["spans"] == []


def test_annotate_on_inside_a_trace_keeps_both(tmp_path, tracer):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("trainer.preview"):
            torch.randn(8, 8).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "prog.trainer.preview" in names
    assert _names(tracer.records()["spans"]) == ["trainer.preview"]


def test_spans_nest_and_self_times_sum_to_the_root(tracer):
    with profiling.annotate("a", job=1):
        with profiling.annotate("b"):
            with profiling.annotate("c"):
                pass
        with profiling.annotate("b"):
            pass
    spans = tracer.records()["spans"]
    by = {s["id"]: s for s in spans}
    assert sorted(_names(spans)) == ["a", "b", "b", "c"]
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["attrs"] == {"job": 1}
    assert all(by[s["parent"]]["name"] == {"b": "a", "c": "b"}[s["name"]]
               for s in spans if s is not root)
    own = profiling.self_seconds(spans)
    assert all(v >= 0 for v in own.values())
    assert sum(own.values()) == pytest.approx(root["t1"] - root["t0"],
                                              rel=1e-9, abs=1e-12)


def test_a_two_stage_cpu_job_gives_the_trainer_span_tree(tmp_path, tracer):
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    data = _dataset(tmp_path)
    cfg = TrainConfig(cameras_json=os.path.join(data, "cameras.json"),
                      width=32, height=32, stages=2, steps_per_stage=4,
                      batch_size=256, checkpoint_dir="",
                      steps_dir=str(tmp_path / "steps"),
                      scene_json=str(tmp_path / "scene.json"))
    Trainer(cfg, build_dataset(cfg, device="cpu"),
            log=lambda msg: None).run()
    rec = tracer.records()
    spans, names = rec["spans"], _names(rec["spans"])
    by = {s["id"]: s for s in spans}
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "trainer.run"
    assert root["attrs"] == {"seed": cfg.seed}
    assert set(TRAINER_SPANS) <= set(names)
    assert names.count("trainer.stage") == 2
    assert names.count("trainer.density") == 1
    assert names.count("trainer.preview") == 2      # stage_0.png, final_1.png
    assert names.count("trainer.export") == 1
    assert names.count("trainer.loss_read") == 2
    # The CPU runs its steps one at a time: nothing is captured or replayed.
    assert "trainer.capture" not in names and "trainer.replay" not in names
    assert rec["captures"] == []
    stages = [s for s in spans if s["name"] == "trainer.stage"]
    assert [s["attrs"]["stage"] for s in stages] == [0, 1]
    assert all(by[s["parent"]]["name"] == "trainer.run" for s in stages)
    for s in spans:
        if s["name"] in STEP_PHASES:
            assert by[s["parent"]]["name"] == "trainer.stage"
    assert {n for n in names if n.startswith("step.")} == set(
        STEP_PHASES) - {"step.march"}     # dense, plain march in the tail
    density = {k: v for k, v in rec["counters"].items()
               if k.startswith("density.")}
    assert {k: v for k, v in rec["counters"].items()
            if k not in density} == {"jobs": 1, "stages": 2, "steps": 8}
    assert sorted(density) == ["density.in", "density.merged", "density.out",
                               "density.pruned", "density.split"]
    (dens,) = [s for s in spans if s["name"] == "trainer.density"]
    assert [s["name"] for s in spans if s["parent"] == dens["id"]] == list(
        DENSITY_SPANS)
    own = profiling.self_seconds(spans)
    assert sum(own.values()) == pytest.approx(root["t1"] - root["t0"],
                                              rel=1e-9, abs=1e-12)
    out = tmp_path / "spans.json"
    tracer.dump(str(out))
    assert json.loads(out.read_text())["counters"]["steps"] == 8


def _knot_merge_cfg(tmp_path, stages: int, **kw) -> TrainConfig:
    """A tiny config-5-shaped job: 512 spheres seeded ~25 deep on a
    20-sphere knot's points, budget 512, the 0.04 merge at each boundary
    (it leaves ~235 spheres in 256 slots, under the budget)."""
    from benchmark.reference.generate import write_dataset

    data = str(tmp_path / "data")
    write_dataset(data, {"scene": "knot", "views": 2, "size": 32, "gt_n": 20,
                         "gt_k": 128.0, "gt_sharp": 40.0}, "cpu")
    return TrainConfig(
        cameras_json=os.path.join(data, "cameras.json"),
        init_points=os.path.join(data, "points.json"), init_layout="cloud",
        init_n=512, init_points_jitter=0.02, width=32, height=32,
        stages=stages, steps_per_stage=4, batch_size=1024, use_culling=True,
        cull_tile=512, cull_budget=512, sample_mode="tile",
        dataset_order="morton", warm_start=True, cluster_repulsion=True,
        density=dataclasses.replace(DensityConfig(), merge_cell=0.04),
        checkpoint_dir="", steps_dir=str(tmp_path / "steps"),
        scene_json=str(tmp_path / "scene.json"), **kw)


def test_density_counters_balance_over_the_boundaries(tmp_path, tracer):
    """A 3-stage culled CPU job with the merge: the density counters sum
    what each boundary's event records, ``density.in`` less the merged and
    the pruned plus the split is ``density.out``, and each boundary's
    ``trainer.density`` holds its three children."""
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    cfg = _knot_merge_cfg(tmp_path, 3)
    tr = Trainer(cfg, build_dataset(cfg, device="cpu"), log=lambda m: None)
    tr.run()
    c = tracer.records()["counters"]
    events = [e for e in tr.events if e["kind"] == "density"]
    assert len(events) == 2
    assert c["density.in"] == sum(e["n_before"] for e in events)
    assert c["density.out"] == sum(e["n_after"] for e in events)
    assert c["density.merged"] == sum(e["merged"] for e in events) > 0
    assert c["density.split"] == sum(e["split"] for e in events)
    assert (c["density.in"] - c["density.merged"] - c["density.pruned"]
            + c["density.split"]) == c["density.out"]
    spans = tracer.records()["spans"]
    for dens in (s for s in spans if s["name"] == "trainer.density"):
        assert [s["name"] for s in spans
                if s["parent"] == dens["id"]] == list(DENSITY_SPANS)


class _ReplayedOnHost:
    """Stands in for a captured graph on the CPU: a replay runs the
    runner's steps one at a time."""

    def __init__(self, runner):
        self.runner = runner

    def replay(self):
        for _ in range(self.runner.unroll):
            self.runner._one(None)


def test_the_capture_names_its_stage_and_rows(tmp_path, tracer,
                                              monkeypatch):
    """``trainer.capture`` carries the stage and the table's rows: across
    the merge the job's two captures name both widths, 512 rows, then the
    256 that are fewer than the budget. (The CPU has no graphs: the
    capture's recording is stood in for by plain steps under
    ``TRACER.capture``.)"""
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    def record(self, first):
        with TRACER.capture(None, nodes=dict) as self.capture_id:
            self._one(None)
        self.graph = _ReplayedOnHost(self)

    monkeypatch.setattr(ChunkRunner, "_record", record)
    monkeypatch.setattr(Trainer, "_replays_graphs", lambda self: True)
    cfg = _knot_merge_cfg(tmp_path, 2)
    Trainer(cfg, build_dataset(cfg, device="cpu"), log=lambda m: None).run()
    caps = [s["attrs"] for s in tracer.records()["spans"]
            if s["name"] == "trainer.capture"]
    assert [(a["stage"], a["rows"]) for a in caps] == [(0, 512), (1, 256)]
    assert [a["capture"] for a in caps] == [
        c["id"] for c in tracer.records()["captures"]]


def test_density_control_runs_the_same_operators_traced(tmp_path):
    """The density spans and counters add no tensor operator: a boundary
    dispatches the same operators with the tracer on as off."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg = _knot_merge_cfg(tmp_path, 2)
    tr = Trainer(cfg, build_dataset(cfg, device="cpu"), log=lambda m: None)
    init = tr._init_params()
    padded, mask = pad_params(init, 512)
    centers = init.centers.detach().numpy()
    seen = {}
    for on in (False, True):
        TRACER.reset()
        if on:
            TRACER.enable()
        try:
            with Ops() as ops:
                out = tr._density_control(padded, mask, init.n, centers, 0,
                                          np.random.default_rng(0))
            seen[on] = (ops.seen, out.n)
        finally:
            TRACER.disable()
            TRACER.reset()
    assert seen[True] == seen[False]


def test_the_culled_step_counts_its_tiles_and_valid_entries(tmp_path,
                                                            tracer):
    """A culled CPU stage: ``tiles`` is steps × batch / tile, and the device
    counters hold the valid entries of every table the steps selected (the
    count the benchmark makes by wrapping ``culled_tables``) and the tiles
    whose selection kept no slot (``empty_tiles``)."""
    from burn_raymarching_tpu_torch.train import step_body
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    data = _dataset(tmp_path)
    cfg = TrainConfig(cameras_json=os.path.join(data, "cameras.json"),
                      width=32, height=32, stages=1, steps_per_stage=6,
                      batch_size=128, checkpoint_dir="", use_pallas=False,
                      use_culling=True, cull_tile=16, cull_budget=8,
                      sample_mode="tile", dataset_order="morton",
                      warm_start=True, warm_steps=4,
                      steps_dir=str(tmp_path / "steps"),
                      scene_json=str(tmp_path / "scene.json"))
    tr = Trainer(cfg, build_dataset(cfg, device="cpu"), log=lambda m: None)
    seen, empty = [], []
    real = step_body.culled_tables

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(int(out[1].sum()))
        empty.append(int((~out[1].any(dim=1)).sum()))
        return out

    tr.prefill_t_cache = lambda *a, **k: None   # its tables are not steps'
    step_body.culled_tables = counted
    try:
        tr.run()
    finally:
        step_body.culled_tables = real
    counters = tracer.records()["counters"]
    assert counters["steps"] == 6
    assert counters["tiles"] == 6 * 128 // 16
    assert counters["table_slots"] == counters["tiles"] * 8
    assert len(seen) == 6
    assert counters["valid_entries"] == sum(seen)
    assert 0 < counters["valid_entries"] <= counters["tiles"] * 8
    assert counters["empty_tiles"] == sum(empty)
    names = _names(tracer.records()["spans"])
    assert {"step.select", "step.march", "trainer.prefill"} <= set(names)


def test_the_device_counters_count_valid_entries_and_empty_tiles(tracer):
    """``add_valid`` adds a selection's valid entries and its tiles that
    keep a valid slot (selections keep a tile's valid slots first);
    ``records`` reports the tiles that keep none as ``empty_tiles``, and
    nothing of either before steps have counted table slots."""
    kept = torch.tensor([3, 0, 1, 4, 0])            # valid slots of 5 tiles
    valid = torch.arange(4)[None, :] < kept[:, None]
    tracer.add_valid(valid)
    assert "empty_tiles" not in tracer.records()["counters"]
    tracer.count("tiles", 5)
    tracer.count("table_slots", valid.numel())
    tracer.add_valid(valid[:2])
    tracer.count("tiles", 2)
    tracer.count("table_slots", 8)
    counters = tracer.records()["counters"]
    assert counters["valid_entries"] == 8 + 3
    assert counters["empty_tiles"] == 2 + 1
    tracer.reset()
    assert tracer.records()["counters"] == {}


def test_the_phase_map_and_the_counts_of_a_replay(tracer):
    """``TRACER.capture`` with a stand-in for libcuda's node list: nodes
    are credited in capture order to the span open while they were
    recorded (kernels, copies and memsets; other nodes are not device
    events), and what the captured step counts is added per replay."""
    graph: dict = {}

    def record(kinds):
        for k in kinds:
            graph[len(graph)] = k

    with profiling.annotate("trainer.capture"):
        with TRACER.capture(None, nodes=lambda: dict(graph)) as cid:
            with profiling.annotate("step.sample"):
                record([0, 0])
                TRACER.count("steps")
            record([5])                            # an empty node
            with profiling.annotate("step.select"):
                record([0, 2, 1])
                TRACER.count("tiles", 32)
            with profiling.annotate("step.select"):
                record([0])
            with profiling.annotate("step.adam"):
                record([0, 7])                     # and an event record
            record([0])
    (cap,) = TRACER.captures[-1:]
    assert cap["id"] == cid and cap["error"] is None
    assert cap["phases"] == [["step.sample", 2], ["step.select", 4],
                             ["step.adam", 1], ["trainer.capture", 1]]
    assert cap["nodes"] == {"kernel": 6, "memcpy": 1, "memset": 1,
                            "other": 2}
    assert cap["per_replay"] == {"steps": 1, "tiles": 32}
    assert "steps" not in TRACER.counters
    TRACER.replayed(cid, 10)
    assert TRACER.counters == {"captures": 1, "replays": 10, "steps": 10,
                               "tiles": 320}


def test_a_failing_node_query_leaves_the_capture_without_a_map(tracer):
    def broken():
        raise RuntimeError("no graph")

    with TRACER.capture(None, nodes=broken) as cid:
        with profiling.annotate("step.sample"):
            pass
    cap = TRACER.captures[-1]
    assert cap["id"] == cid and cap["phases"] == []
    assert "no graph" in cap["error"]


def test_attribution_of_synthetic_replays():
    """A replay whose event count matches the map is attributed in order;
    one with an event too many is left out and its time counted; the
    capture's warm-up events are no replay's (another correlation id), so
    they are not passed in."""
    phases = [["step.sample", 2], ["step.tail", 1], ["step.adam", 2]]

    def replay(t0, n):
        return [(t0 + 10.0 * i, t0 + 10.0 * i + 4.0, f"k{i}")
                for i in range(n)]

    good = replay(0.0, 5)
    assert profiling.attribute(good, phases) == [
        "step.sample", "step.sample", "step.tail", "step.adam", "step.adam"]
    assert profiling.attribute(replay(0.0, 6), phases) is None
    got = profiling.phase_seconds([good, replay(100.0, 6), replay(200.0, 5)],
                                  phases)
    assert got["replays"] == 2
    assert got["unattributed_s"] == pytest.approx(6 * 4e-6)
    assert got["phases"] == pytest.approx(
        {"step.sample": 16e-6, "step.tail": 8e-6, "step.adam": 16e-6})


def test_a_viewer_frame_gives_one_frame_span_with_five_children(tracer):
    from burn_raymarching_tpu_torch.tools.viewer_server import _ViewerState

    state = _ViewerState(SCENE, 64, "train", device="cpu")
    png = state.render(0.3, 0.2, 2.5, (0.0, 0.0, 0.0), "low")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    spans = tracer.records()["spans"]
    (frame,) = [s for s in spans if s["name"] == "view.frame"]
    assert frame["parent"] is None
    assert frame["attrs"] == {"frame": 0, "quality": "low", "size": 64}
    children = [s["name"] for s in spans if s["parent"] == frame["id"]]
    assert children == ["view.scene_upload", "view.rays", "view.render",
                        "view.readback", "view.encode"]
    assert tracer.records()["counters"] == {"frames.low": 1}


def test_the_viewer_server_writes_its_frames_spans(tmp_path, monkeypatch):
    from burn_raymarching_tpu_torch.tools import viewer_server

    class Server:
        """Serves one preview frame, then stops as on ^C."""

        def __init__(self, address, handler):
            self.handler = handler

        def serve_forever(self):
            handler = self.handler.__new__(self.handler)
            handler.path = "/frame?q=low&yaw=0.3"
            handler.send_response = handler.send_header = (
                lambda *a: None)
            handler.end_headers = lambda: None
            handler.wfile = type("W", (), {"write": lambda _, b: None})()
            handler.do_GET()
            raise KeyboardInterrupt

        def server_close(self):
            pass

    monkeypatch.setattr(viewer_server, "ThreadingHTTPServer", Server)
    out = tmp_path / "spans.json"
    viewer_server.main([SCENE, "--size", "64", "--model", "train",
                        "--device", "cpu", "--trace-spans", str(out)])
    assert not TRACER.on
    with open(out) as f:
        got = json.load(f)
    assert _names(got["spans"]).count("view.frame") == 1
    assert len(got["spans"]) == 6
    assert got["counters"] == {"frames.low": 1}
    TRACER.reset()


# --- on the card ---------------------------------------------------------- #

def _cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _events_per_launch(trace_path: str) -> list[int]:
    """Device events (kernels, copies, memsets) of each cudaGraphLaunch in a
    torch.profiler trace, matched by correlation id, in launch order."""
    with open(trace_path) as f:
        raw = json.load(f)["traceEvents"]
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in raw
                      if e.get("cat") == "cuda_runtime"
                      and "GraphLaunch" in e.get("name", ""))
    per: dict = {}
    for e in raw:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            c = e.get("args", {}).get("correlation")
            per[c] = per.get(c, 0) + 1
    return [per.get(c, 0) for _, c in launches]


def _capture_runner(tmp_path, device, culled: bool):
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer
    from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree

    data = _dataset(tmp_path, size=128 if culled else 64)
    kw = (dict(width=128, height=128, batch_size=4096, use_culling=True,
               cull_tile=512, cull_budget=64, sample_mode="tile",
               dataset_order="morton", warm_start=True, warm_steps=16,
               init_n=300, init_layout="cloud")
          if culled else
          dict(width=64, height=64, batch_size=16384))
    cfg = TrainConfig(cameras_json=os.path.join(data, "cameras.json"),
                      steps_per_stage=100, checkpoint_dir="", **kw)
    tr = Trainer(cfg, build_dataset(cfg, device=device), log=lambda m: None)
    padded, mask = pad_params(tr._init_params(), 512 if culled else 16)
    fg, n_fg = tr._sample_fg
    if tr.warm:
        tr.prefill_t_cache(padded, mask, 128.0)
    return ChunkRunner(
        tr.step_fn, padded, make_optimizer(cfg, padded),
        lr_scale_tree(cfg, 0), 0, mask, tr.dataset.packed, fg, n_fg,
        torch.Generator(device=device).manual_seed(5), t_cache=tr.t_cache,
        graphs=True)


@pytest.mark.cuda
@pytest.mark.parametrize("culled", [False, True], ids=["c1", "culled"])
def test_cuda_phase_map_counts_each_replays_device_events(tmp_path, culled):
    """A captured step (config 1's width dense; a small culled one) with the
    tracer on: each replay in a profiler trace has as many device events
    as its phase map counts, and the map covers every phase the step
    runs. Captured with the tracer off, the same step's replays have
    exactly the tracer's counter nodes fewer (none on the dense path)."""
    device = _cuda_device()
    counts = {}
    for on in (True, False):
        TRACER.reset()
        if on:
            TRACER.enable()
        try:
            runner = _capture_runner(tmp_path / str(on), device, culled)
            runner.run(1, 2)              # capture, two replays
            torch.cuda.synchronize()
            logdir = str(tmp_path / f"trace_{on}")
            with profiling.trace(logdir):
                runner.run(3, 3)
            counts[on] = _events_per_launch(os.path.join(logdir,
                                                         "trace.json"))
            if on:
                cap = TRACER.captures[-1]
                assert cap["error"] is None
                total = sum(n for _, n in cap["phases"])
                phases = {p for p, _ in cap["phases"]}
                assert phases <= set(STEP_PHASES) | {"trainer.capture"}
                assert {"step.sample", "step.tail", "step.loss",
                        "step.backward", "step.adam"} <= phases
                assert runner.capture_id == cap["id"]
                assert TRACER.counters["replays"] == 5
                assert TRACER.counters["steps"] == 5
            runner.close()
        finally:
            TRACER.disable()
            TRACER.reset()
    assert counts[True] == [total] * 3
    # The counter's own nodes: a graph of just the add.
    extra = 0
    if culled:
        TRACER.enable()
        try:
            valid = torch.ones((8, 64), dtype=torch.bool, device=device)
            TRACER.device_counter(device)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side), \
                    TRACER.capture(side):
                TRACER.add_valid(valid)
            extra = sum(n for _, n in TRACER.captures[-1]["phases"])
            assert extra >= 1
        finally:
            TRACER.disable()
            TRACER.reset()
    assert counts[False] == [total - extra] * 3

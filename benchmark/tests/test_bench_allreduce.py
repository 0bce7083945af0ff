"""The data-parallel cell's per-layer readers on a synthetic traced run:
``grad_mean_ms_per_step.dp4`` (the captured step's ``step.grad_mean``
phase) and ``allreduce_roofline.dp4`` (harness/allreduce.py: the NCCL
kernels of that phase against the ring's bus bytes at the card's one-way
NVLink bandwidth); both read nothing from a program whose step has no
such phase; and nvidia-smi's link report parsed."""

import types

import pytest

from benchmark.harness import allreduce, devtrace
from benchmark.harness.manifest import metric_reader

NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"
GRAPH = ["add", "gather", "k3", "tail", "bwd", "cat", NCCL, "div", "copy",
         "adam"]
PHASES = [["step.sample", 2], ["step.march", 1], ["step.tail", 1],
          ["step.backward", 1], ["step.grad_mean", 4], ["step.adam", 1]]
NCCL_US, REPLAYS, NBYTES, RANKS = 20.0, 5, 229396, 4


def traced_run(phases, per_replay):
    """A slice holding one ``ChunkRunner.run`` of REPLAYS replays: each a
    two-event prologue and GRAPH, 1 µs an event but NCCL_US for the NCCL
    kernel."""
    raw = [{"cat": "user_annotation", "ts": 1e6, "dur": 49e6,
            "name": "bench.slice"}]
    t = 1e6 + 100.0
    for _ in range(REPLAYS):
        for name in ["fill", "fill"] + GRAPH:
            dur = NCCL_US if name == NCCL else 1.0
            raw.append({"cat": "kernel", "ts": t, "dur": dur, "name": name})
            t += dur
        t += 50.0
    sp = devtrace.Spans(True)
    sp.items += [("pause", 0.0, 1.0), ("pause", 50.0, 51.0)]
    run = types.SimpleNamespace(spans=sp, window=(0.0, 60.0),
                                events=devtrace.Events(raw), ranks=RANKS)
    run.program = {
        "spans": [{"id": 1, "parent": None, "name": "trainer.replay",
                   "t0": 1.00005, "t1": 1.0001,
                   "attrs": {"capture": 1, "replays": REPLAYS}}],
        "counters": {}, "captures": [{"id": 1, "phases": phases,
                                      "nodes": {}, "per_replay": per_replay,
                                      "error": None}]}
    return run


def test_the_grad_mean_phase_per_step():
    run = traced_run(PHASES, {"steps": 1, "grad_mean.bytes": NBYTES})
    got = metric_reader("grad_mean_ms_per_step.dp4")(run)
    assert got == pytest.approx((3.0 + NCCL_US) / 1000.0)


def test_the_allreduce_against_its_roofline(monkeypatch):
    monkeypatch.setattr(allreduce, "nvlink_peak", lambda card=0: 478e9)
    run = traced_run(PHASES, {"steps": 1, "grad_mean.bytes": NBYTES})
    got = allreduce.grad_mean_nccl(run)
    assert got["steps"] == REPLAYS and got["bytes"] == REPLAYS * NBYTES
    assert got["nccl_s"] == pytest.approx(REPLAYS * NCCL_US * 1e-6)
    share = metric_reader("allreduce_roofline.dp4")(run)
    least = 2 * (RANKS - 1) / RANKS * NBYTES / 478e9
    assert share == pytest.approx(100.0 * least / (NCCL_US * 1e-6))


def test_a_step_without_the_phase_reads_nothing(monkeypatch):
    """The parent's step: the all-reduce inside ``step.backward``, no
    counter of its bytes."""
    monkeypatch.setattr(allreduce, "nvlink_peak", lambda card=0: 478e9)
    phases = [["step.sample", 2], ["step.march", 1], ["step.tail", 1],
              ["step.backward", 5], ["step.adam", 1]]
    run = traced_run(phases, {"steps": 1})
    assert metric_reader("grad_mean_ms_per_step.dp4")(run) is None
    assert metric_reader("allreduce_roofline.dp4")(run) is None


def test_nvidia_smi_link_speeds():
    status = ("GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-x)\n"
              + "".join(f"\t Link {i}: 26.562 GB/s\n" for i in range(18)))
    assert allreduce.link_bytes_per_s(status) == pytest.approx(
        18 * 26.562e9)
    assert allreduce.link_bytes_per_s("GPU 0: no links") is None

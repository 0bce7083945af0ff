"""tools/bench_large.py (the port's scripts/bench_large.py) at a tiny size
on the CPU: every (budget, far field, variant) case runs the trainer's
culled step with hierarchical selection and cluster repulsion as a chained
chunk (train/chunk.ChunkRunner; on the CPU one step at a time) and reports
a finite loss, the chained and the one-at-a-time wall time; and the bench's
large-scene flagship (tools/bench.large_flagship) at a tiny size. Device
times are taken on the card only."""

from __future__ import annotations

import json

import pytest

from burn_raymarching_tpu_torch.tools import bench_large


def test_bench_large_cpu_smoke(tmp_path):
    out = tmp_path / "bench.jsonl"
    records = bench_large.main([
        "--m", "256", "--batch", "512", "--pixels", "4096", "--side", "32",
        "--steps", "2", "--budgets", "64,16", "--tile", "128", "--group",
        "8", "--cluster-budget", "4", "--reps", "1", "--device", "cpu",
        "--out", str(out)])
    assert len(records) == 12
    assert {(r["budget"], r["far_field"], r["variant"]) for r in records} == {
        (b, f, v) for b in (64, 16) for f in ("member", "monopole")
        for v in ("plain", "kernel", "warm")}
    for r in records:
        assert r["hier"] and r["wall_ms_per_step"] > 0
        assert (r["prefill_s"] > 0) == (r["variant"] == "warm")
        assert "device_busy_ms_per_step" not in r
        assert r["graphs"] is False and r["steps_per_call"] == 2
        assert r["wall_ms_per_step_one_at_a_time"] > 0
        assert r["steps_run"] == 4 and r["reps"] == 1
    assert [json.loads(line) for line in out.read_text().splitlines()
            ] == records


def test_large_flagship_cpu_tiny():
    """The flagship (bench.py:224-250) at a tiny size on the CPU: the warm
    culled step with the monopole far field and hierarchical selection,
    chained ``steps`` steps a call → its ms per step, rays/s and record."""
    from burn_raymarching_tpu_torch.tools import bench

    ms, rays, rec = bench.large_flagship(
        steps=2, reps=1, device="cpu", m=256, pixels=4096, side=32,
        batch_size=512, cull_budget=16, cull_tile=128,
        cull_cluster_group=8, cull_cluster_budget=4)
    assert ms == rec["wall_ms_per_step"] > 0
    assert rays == pytest.approx(512 / ms * 1000.0)
    assert rec["variant"] == "warm" and rec["far_field"] == "monopole"
    assert rec["hier"] and rec["budget"] == 16 and rec["m"] == 256
    assert rec["warm_steps"] == 16 and rec["steps_per_call"] == 2
    assert rec["graphs"] is False and rec["prefill_s"] > 0
    assert rec["wall_ms_per_step_one_at_a_time"] > 0
    cfg = bench.flagship_config()
    assert (cfg.batch_size, cfg.cull_budget, cfg.cull_tile,
            cfg.cull_cluster_group, cfg.cull_cluster_budget,
            cfg.warm_steps, cfg.steps_per_call) == (
        16384, 256, 512, 64, 32, 16, 50)
    assert cfg.use_culling and cfg.cull_hierarchical
    assert cfg.cluster_repulsion and cfg.warm_start
    assert cfg.weight_decay_mode == "decoupled"
    assert cfg.loss.repulsion_far_field == "monopole"

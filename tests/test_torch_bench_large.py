"""tools/bench_large.py (the port's scripts/bench_large.py) at a tiny size
on the CPU: every (budget, far field, variant) case runs the trainer's
culled step with hierarchical selection and cluster repulsion and reports
a finite loss and a wall time. Device times are taken on the card only."""

from __future__ import annotations

import json

from burn_raymarching_tpu_torch.tools import bench_large


def test_bench_large_cpu_smoke(tmp_path):
    out = tmp_path / "bench.jsonl"
    records = bench_large.main([
        "--m", "256", "--batch", "512", "--pixels", "4096", "--side", "32",
        "--steps", "2", "--budgets", "64,16", "--tile", "128", "--group",
        "8", "--cluster-budget", "4", "--device", "cpu", "--out", str(out)])
    assert len(records) == 12
    assert {(r["budget"], r["far_field"], r["variant"]) for r in records} == {
        (b, f, v) for b in (64, 16) for f in ("member", "monopole")
        for v in ("plain", "kernel", "warm")}
    for r in records:
        assert r["loss_finite"] and r["hier"] and r["wall_ms_per_step"] > 0
        assert (r["prefill_s"] > 0) == (r["variant"] == "warm")
        assert "device_busy_ms_per_step" not in r
    assert [json.loads(line) for line in out.read_text().splitlines()
            ] == records

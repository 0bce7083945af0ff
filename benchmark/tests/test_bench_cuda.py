"""Each cell through the command line, as the check runs it (needs a
card: ``python -m pytest benchmark/tests -m cuda`` on a machine with
one)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest.load()["workloads"]])
def test_a_short_run_of_each_cell_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483648", "--seconds", "3", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command prints no result and fails."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "c4_knot.view",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_outside_a_checkout_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command fails and prints no result."""
    import shutil

    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "c4_knot.view",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

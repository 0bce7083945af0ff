"""BENCHMARK.json against the contract, and the discovery by name."""

import copy
import hashlib
import json
import os
import shutil

import pytest

from benchmark.harness import manifest


def test_benchmark_json_is_valid():
    assert manifest.validate(manifest.load()) == []


def _broken(edit):
    m = copy.deepcopy(manifest.load())
    edit(m)
    return manifest.validate(m)


@pytest.mark.parametrize("edit", [
    lambda m: m["workloads"][0].update(name="has space"),
    lambda m: m["workloads"][0].update(name="a/b"),
    lambda m: m["end_to_end"][0].update(unit="rays per s"),
    lambda m: m["end_to_end"][0].update(unit="µs"),
    lambda m: m["end_to_end"][0].update(bound=0.3),
    lambda m: m["end_to_end"].pop(),
    lambda m: m["per_layer"][0].update(why="a reason"),
    lambda m: m["per_layer"][0].update(moves="no_such_metric"),
    lambda m: m["workloads"].append(dict(m["workloads"][0], name="copy")),
    lambda m: m["configs"][0].update(reduced=["hidden_size"]),
    lambda m: m.update(run_seconds=52),
    lambda m: m.update(command=["python3", "/abs/run.py"]),
    lambda m: m["workloads"][0].update(chips=2),
], ids=["space", "slash", "unit-space", "unit-greek", "bound", "no-setup",
        "metric-why", "moves", "pair-twice", "width-cut", "run-seconds",
        "abs-command", "chips"])
def test_malformed_manifest_is_refused(edit):
    assert _broken(edit)


def test_every_cell_is_found_by_name():
    m = manifest.load()
    for w in m["workloads"]:
        cell = manifest.Cell(m, w["name"])
        assert cell.traffic["kind"] in ("train", "view")
        mod = manifest.kind_module(cell.traffic["kind"])
        assert callable(mod.run) and callable(mod.readings)
        assert set(cell.limits) and cell.config["name"] == w["config"]
        assert any(e["name"] == "setup_s" for e in cell.end_to_end)
        for p in cell.per_layer:
            assert callable(manifest.metric_reader(p["name"]))


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" in base:
                continue
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell are
    added by new files and new entries: no file of the benchmark changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    before = _digests(str(root))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "c1_dango.json").read_text())
    cfg["name"] = "c1_dango_big"
    cfg["train"]["batch_size"] = 32768
    (b / "configs" / "c1_dango_big.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "train.json").read_text())
    traffic["job_pool"] = 4
    (b / "traffic" / "train_small_pool.json").write_text(json.dumps(traffic))
    (b / "metrics" / "dummy_share.train.py").write_text(
        "def read(run):\n    return 42.0\n")
    (b / "limits" / "c1_dango_big.train_small_pool.json").write_text(
        (b / "limits" / "c1_dango.train.json").read_text())
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({
        "name": "c1_dango_big", "source": m["configs"][0]["source"],
        "file": "benchmark/configs/c1_dango_big.json",
        "reduced": [], "why": "a bigger batch"})
    m["workloads"].append({
        "name": "c1_dango_big.train_small_pool", "config": "c1_dango_big",
        "traffic": "train_small_pool", "chips": 1, "why": "a test cell"})
    m["end_to_end"][0]["workloads"].append("c1_dango_big.train_small_pool")
    m["per_layer"].append({
        "name": "dummy_share.train", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "train_rays_per_s",
        "workloads": ["c1_dango_big.train_small_pool"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.validate(m, str(root)) == []
    cell = manifest.Cell(m, "c1_dango_big.train_small_pool", str(root))
    assert cell.config["train"]["batch_size"] == 32768
    assert cell.traffic["job_pool"] == 4
    assert [p["name"] for p in cell.per_layer] == ["dummy_share.train"]
    assert manifest.metric_reader("dummy_share.train", str(root))(None) \
        == 42.0
    after = _digests(str(root))
    assert {k: after[k] for k in before} == before


def test_a_new_traffic_kind_is_a_new_file(tmp_path):
    """A traffic kind is found by name from its mix's ``kind``: a new
    kind is a new ``harness/<kind>.py``, and no file of the benchmark
    changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    before = _digests(str(root))
    b = root / "benchmark"
    (b / "harness" / "dummy_kind.py").write_text(
        "def run(*args, **kwargs):\n    return 'ran'\n\n\n"
        "def readings(*args, **kwargs):\n    return {}\n")
    (b / "traffic" / "dummy.json").write_text(json.dumps({
        "kind": "dummy_kind"}))
    (b / "limits" / "c4_knot.dummy.json").write_text("{}")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "c4_knot.dummy", "config": "c4_knot",
                           "traffic": "dummy", "chips": 1,
                           "why": "a test cell"})
    m["end_to_end"][0]["workloads"].append("c4_knot.dummy")
    m["per_layer"][0]["workloads"].append("c4_knot.dummy")
    assert manifest.validate(m, str(root)) == []
    cell = manifest.Cell(m, "c4_knot.dummy", str(root))
    mod = manifest.kind_module(cell.traffic["kind"], str(root))
    assert mod.run() == "ran"
    with pytest.raises(ValueError):
        manifest.kind_module("no_such_kind", str(root))
    with pytest.raises(ValueError):
        manifest.kind_module("stats", str(root))
    after = _digests(str(root))
    assert {k: after[k] for k in before} == before

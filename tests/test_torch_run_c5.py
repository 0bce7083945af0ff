"""tools/run_c5.py against scripts/run_c5.py: the same flags, the same
TrainConfig for the same argv, and a results.json that records what ran.

The JAX script has no parser of its own: ``main`` builds it and the
config, then calls ``build_dataset`` (imported inside ``main``) before it
trains. The oracle loads the script as the JAX package's tests import the
package, points ``--data`` at a tiny dataset in tmp_path (so nothing is
generated), and replaces ``burn_raymarching_tpu.train.loop.build_dataset``
with a function that records its config and stops the run. The two
configs are held equal field by field, nested ones included, through the
port's copy of the dataclasses (burn_raymarching_tpu_torch/config.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
from torch_parity import tiny_knot_dataset

from burn_raymarching_tpu_torch.tools import run_c5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = {
    "config5_defaults": [],
    "config4": ["--views", "30", "--size", "512", "--gt-n", "400",
                "--init-n", "5120", "--cull-budget", "2048", "--stages", "3",
                "--merge-cell", "0.04"],
    "c5_headline": ["--stages", "5", "--merge-cell", "0.04",
                    "--cull-budget", "2048", "--coverage", "gaussian",
                    "--mask-sharp", "40", "--coverage-stages",
                    "sigmoid,gaussian", "--fringe-weight", "10",
                    "--fringe-threshold", "0.3", "--refine", "1",
                    "--refine-bias", "residual", "--seed", "1"],
    "every_recipe_flag": [
        "--prior", "dense", "--hier", "--far-field", "monopole",
        "--no-repulsion", "--sample-mode", "pixel", "--batch", "8192",
        "--jitter", "0.05", "--lr-centers", "0.002", "--lr-radii", "0.2",
        "--lr-light", "0.25", "--base-lr", "0.03", "--mask-px", "1.5",
        "--mask-sharp", "40", "--mask-sharp-stages", "10,20,40",
        "--ss-stages", "1,4,1", "--mask-px-stages", "0,1.5",
        "--split-mode", "residual", "--split-budget", "7",
        "--split-frac", "0.5", "--lr-centers-stages", "0.001,0.01",
        "--refine-max-budget", "4096", "--steps", "250", "--stages", "3",
        "--init-n", "1000"],
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("c5") / "data")
    tiny_knot_dataset(path)
    return path


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_c5_oracle", os.path.join(ROOT, "scripts", "run_c5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _jax_config(monkeypatch, argv):
    """The TrainConfig scripts/run_c5.py builds for ``argv``."""
    import burn_raymarching_tpu.train.loop as jax_loop

    # The script sets this variable with setdefault at import; keep the
    # test process's environment as it was.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       os.environ.get("JAX_COMPILATION_CACHE_DIR", ""))
    seen = {}

    def record(cfg):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(jax_loop, "build_dataset", record)
    with pytest.raises(_Stop):
        _jax_script().main(argv)
    return seen["cfg"]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_same_argv_builds_the_same_train_config(monkeypatch, tmp_path,
                                                data_dir, name):
    argv = ["--out", str(tmp_path / "out"), "--data", data_dir,
            *ARGVS[name]]
    want = _jax_config(monkeypatch, argv)
    args = run_c5.make_parser().parse_args(argv)
    got = run_c5.build_config(args, data_dir)
    assert ({f.name for f in dataclasses.fields(got)}
            == {f.name for f in dataclasses.fields(want)})
    d_got, d_want = dataclasses.asdict(got), dataclasses.asdict(want)
    for field in d_want:
        assert d_got[field] == d_want[field], field


def test_every_flag_of_the_jax_script(monkeypatch, data_dir, tmp_path):
    """The port's parser has every option of scripts/run_c5.py with the
    same default (and adds only --device and --distributed's --mesh)."""
    seen = {}

    def capture(self, argv=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Stop):
        _jax_script().main([])
    monkeypatch.undo()
    want = {a.dest: (tuple(a.option_strings), a.default)
            for a in seen["parser"]._actions if a.dest != "help"}
    got = {a.dest: (tuple(a.option_strings), a.default)
           for a in run_c5.make_parser()._actions if a.dest != "help"}
    assert set(got) - set(want) == {"device", "mesh"}
    for dest, (opts, default) in want.items():
        assert got[dest][0] == opts, dest
        if dest != "out":    # the port writes runs/c5_torch, not runs/c5
            assert got[dest][1] == default, dest


def test_results_record_what_ran(tmp_path, data_dir):
    """A tiny CPU run with non-default recipe flags: results.json reports
    the prior, the per-stage lists and fringe_weight as they ran."""
    out = str(tmp_path / "run")
    res = run_c5.main([
        "--out", out, "--data", data_dir, "--views", "2", "--size", "32",
        "--init-n", "120", "--cull-budget", "64", "--batch", "512",
        "--steps", "2", "--stages", "2", "--prior", "dense",
        "--fringe-weight", "10", "--mask-sharp", "40",
        "--mask-sharp-stages", "20,40", "--coverage", "gaussian",
        "--coverage-stages", "sigmoid,gaussian",
        "--lr-centers-stages", "0.001,0.002", "--skip-ceiling", "--cpu"])
    with open(os.path.join(out, "results.json")) as f:
        saved = json.load(f)
    for r in (res, saved):
        assert r["prior"] == "dense"
        assert r["fringe_weight"] == 10.0
        assert r["mask_sharp_stages"] == "20,40"
        assert r["coverage_stages"] == "sigmoid,gaussian"
        assert r["ss_stages"] == "" and r["mask_px_stages"] == ""
        assert r["lr_centers_stages"] == [0.001, 0.002]
        assert r["ceiling"] is None
        assert r["init"] > 0 and r["trained"] > 0
    assert os.path.exists(os.path.join(out, "points_dense.json"))
    assert os.path.exists(os.path.join(out, "scene_c5.json"))


def test_distributed_results_record_how_the_steps_ran(tmp_path, data_dir):
    """``--distributed`` on the CPU (a gloo world of one, in its own
    process, as torch.distributed.run would start it): results.json
    records that the sharded steps ran one at a time over gloo on a 1 x 1
    mesh, as the trainer's "graphs" event does; a plain run records its
    mode with a null backend and mesh."""
    out = str(tmp_path / "dist")
    argv = ["--out", out, "--data", data_dir, "--views", "2", "--size", "32",
            "--init-n", "120", "--cull-budget", "64", "--batch", "512",
            "--steps", "2", "--stages", "1", "--skip-ceiling", "--cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "burn_raymarching_tpu_torch.tools.run_c5",
         *argv, "--distributed"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(out, "results.json")) as f:
        saved = json.load(f)
    assert saved["distributed"] is True
    assert (saved["graphs"], saved["backend"], saved["mesh"]) == (
        False, "gloo", [1, 1])
    graphs = [e for e in saved["events"] if e["kind"] == "graphs"]
    assert graphs == [dict(kind="graphs", graphs=False, backend="gloo",
                           mesh=[1, 1])]
    plain = run_c5.main([*argv[:1], str(tmp_path / "plain"), *argv[2:]])
    assert (plain["graphs"], plain["backend"], plain["mesh"]) == (
        False, None, None)


def test_ceiling_only_merges_into_results(tmp_path, data_dir):
    out = str(tmp_path / "ceil")
    os.makedirs(out)
    with open(os.path.join(out, "results.json"), "w") as f:
        json.dump({"trained": 20.0, "coverage": "gaussian"}, f)
    res = run_c5.main(["--out", out, "--data", data_dir, "--size", "32",
                       "--gt-n", "400", "--cull-budget", "64",
                       "--init-n", "120", "--ceiling-only", "--cpu"])
    assert res["trained"] == 20.0 and res["coverage"] == "gaussian"
    assert res["ceiling"] > 20.0
    assert res["ceiling_evaluator"] == "tools/run_c5.py --ceiling-only"

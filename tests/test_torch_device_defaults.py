"""The port's device rule: every public entry point runs on the card unless
the caller names the CPU, and says so when there is no card.

(a) no ``def`` of the port gives ``device`` a CPU default (an AST scan, one
case per function); (b) the eight library entry points that build tensors
from host data, called with no device on a machine without a card, raise
the RuntimeError of ``utils.device.resolve_device`` that names
``device="cpu"``, not torch's "not compiled with CUDA" and not a silent
CPU run; (c) with ``device="cpu"`` each of them lands on the CPU.
"""

import ast
import os

import numpy as np
import pytest
import torch

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.data.dataset import RayDataset
from burn_raymarching_tpu_torch.models.scene import (
    init_scene_params,
    init_scene_params_cloud,
    params_from_numpy,
    raw_from_physical,
)
from burn_raymarching_tpu_torch.ops.culling import build_clusters
from burn_raymarching_tpu_torch.tools import generate
from burn_raymarching_tpu_torch.train.loop import build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "burn_raymarching_tpu_torch")


def _device_defaults() -> dict:
    """``path::qualname`` → the default expression of its ``device``
    parameter, for every def of the port whose ``device`` has one."""
    found = {}

    def visit(node, path, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, path, prefix + child.name + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = child.args
                pos = a.posonlyargs + a.args
                pairs = list(zip(pos[len(pos) - len(a.defaults):],
                                 a.defaults))
                pairs += [(arg, d) for arg, d in zip(a.kwonlyargs,
                                                     a.kw_defaults)
                          if d is not None]
                for arg, default in pairs:
                    if arg.arg == "device":
                        found[f"{path}::{prefix}{child.name}"] = default
                visit(child, path, prefix + child.name + ".")

    for folder, dirs, files in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if d not in ("build", "__pycache__"))
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                with open(path) as f:
                    tree = ast.parse(f.read())
                visit(tree, os.path.relpath(path, ROOT), "")
    return found


DEVICE_DEFAULTS = _device_defaults()


@pytest.mark.parametrize("where", sorted(DEVICE_DEFAULTS))
def test_no_device_default_is_the_cpu(where):
    """A default must be a string naming a device that is not the CPU
    ("cuda", "cuda:1"); anything else (None, an expression) is refused, so
    no default can pick the CPU at run time."""
    default = DEVICE_DEFAULTS[where]
    assert (isinstance(default, ast.Constant)
            and isinstance(default.value, str)), (
        f"{where}: device default {ast.unparse(default)} is not a device "
        f"string")
    assert torch.device(default.value).type != "cpu", (
        f"{where}: device defaults to {ast.unparse(default)}; the port runs "
        f"on the card unless the caller names the CPU")


ENTRY_POINTS = ("build_dataset", "create_camera_rays", "RayDataset",
                "raw_from_physical", "params_from_numpy",
                "init_scene_params_cloud", "init_scene_params",
                "build_clusters")


def test_scan_sees_every_entry_point():
    names = {where.rsplit("::", 1)[1] for where in DEVICE_DEFAULTS}
    want = {"RayDataset.__init__" if n == "RayDataset" else n
            for n in ENTRY_POINTS}
    assert want <= names


@pytest.fixture(scope="module")
def cameras_json(tmp_path_factory):
    """A 16² dango capture written by the port's generator on the CPU."""
    out = str(tmp_path_factory.mktemp("data"))
    generate.main(["--out", out, "--size", "16", "--device", "cpu"])
    return os.path.join(out, "cameras.json")


def _call(name: str, cameras: str, **device):
    """Entry point ``name`` on small host inputs → its result."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(-0.5, 0.5, (10, 3)).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (10, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.2, (10, 1)).astype(np.float32)
    if name == "build_dataset":
        return build_dataset(TrainConfig(cameras_json=cameras, width=16,
                                         height=16), **device)
    if name == "create_camera_rays":
        return create_camera_rays(16, 16, [0.0, 0.5, -2.5], [0, 0, 0], 50.0,
                                  **device)
    if name == "RayDataset":
        return RayDataset(centers, colors, radii.repeat(3, axis=1),
                          **device)
    if name == "raw_from_physical":
        return raw_from_physical(centers, colors, radii, **device)
    if name == "params_from_numpy":
        return params_from_numpy(
            {"centers": centers, "colors": colors, "radii": radii,
             "light_dir": np.asarray([0.0, 1.0, 0.0], np.float32),
             "ambient": np.asarray([-1.4], np.float32)}, **device)
    if name == "init_scene_params_cloud":
        return init_scene_params_cloud(10, **device)
    if name == "init_scene_params":
        return init_scene_params(7, **device)
    assert name == "build_clusters"
    return build_clusters(centers, group=4, **device)


def _result_device(out) -> torch.device:
    if isinstance(out, tuple):          # rays, PrimitiveClusters
        return out[0].device
    if isinstance(out, RayDataset):
        return out.device
    return out.centers.device           # SceneParams


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_no_card_without_a_device_raises_naming_the_cpu(name, cameras_json,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        _call(name, cameras_json)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_cpu_lands_on_the_cpu(name, cameras_json):
    out = _call(name, cameras_json, device="cpu")
    assert _result_device(out).type == "cpu"

"""The port imports and renders with JAX blocked, and loads no module of
the JAX package: config and utils are the port's own copies. Pillow and
imageio are blocked too: only the capture tools and the viewer's --video
use them, inside the functions that need them."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["PIL"] = None
sys.modules["imageio"] = None
import torch
torch.set_num_threads(1)
import burn_raymarching_tpu_torch as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
assert "burn_raymarching_tpu_torch.utils.device" in names
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.models.scene import (
    init_scene_params, pad_params, scene_forward)
ro, rd = create_camera_rays(4, 4, [0.0, 0.5, -2.5], [0, 0, 0], 50.0,
                            device="cpu")
padded, mask = pad_params(init_scene_params(7, device="cpu"), 8)
out = scene_forward(padded, ro, rd, 18.5, mask=mask)
assert out.shape == (16, 3) and bool(torch.isfinite(out).all())
jax_pkg = {m for m in sys.modules if m == "burn_raymarching_tpu"
           or m.startswith("burn_raymarching_tpu.")}
assert not jax_pkg, sorted(jax_pkg)
assert sys.modules["jax"] is None
print(len(names))
"""

_IMPORT_LINE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+burn_raymarching_tpu\b(?!_)"
    r"|from\s+burn_raymarching_tpu\b(?!_))", re.M)


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # Every module of the slice was walked (ops, models, render, data,
    # train, tools, cuda wrappers).
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def test_port_sources_name_no_jax_import():
    """No file of the port has an import line for jax or for the JAX
    package."""
    paths = []
    for folder, _, files in os.walk(os.path.join(ROOT,
                                                 "burn_raymarching_tpu_torch")):
        if os.path.basename(folder) in ("build", "__pycache__"):
            continue
        paths += [os.path.join(folder, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 30
    hits = []
    for path in paths:
        with open(path) as f:
            hits += [f"{path}: {m.group(0).strip()}"
                     for m in _IMPORT_LINE.finditer(f.read())]
    assert not hits, hits

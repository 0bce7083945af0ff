"""The port imports and renders with JAX blocked, and reaches into the JAX
package only for its JAX-free config and utils modules (padding, metrics,
and the NumPy-only Morton orders)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import torch
torch.set_num_threads(1)
import burn_raymarching_tpu_torch as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.models.scene import (
    init_scene_params, pad_params, scene_forward)
ro, rd = create_camera_rays(4, 4, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
padded, mask = pad_params(init_scene_params(7), 8)
out = scene_forward(padded, ro, rd, 18.5, mask=mask)
assert out.shape == (16, 3) and bool(torch.isfinite(out).all())
allowed = {"burn_raymarching_tpu", "burn_raymarching_tpu.config",
           "burn_raymarching_tpu.utils", "burn_raymarching_tpu.utils.padding",
           "burn_raymarching_tpu.utils.metrics",
           "burn_raymarching_tpu.utils.morton"}
jax_pkg = {m for m in sys.modules if m == "burn_raymarching_tpu"
           or m.startswith("burn_raymarching_tpu.")}
assert jax_pkg <= allowed, sorted(jax_pkg - allowed)
assert sys.modules["jax"] is None
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # Every module of the slice was walked (ops, models, render, data,
    # train, tools, cuda wrappers).
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20

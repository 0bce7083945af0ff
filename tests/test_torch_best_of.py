"""``train_cli --best-of``: the gate that picks the seed, pinned as a
choice.

The port's gate evaluates every seed with ``Trainer.views_psnr``: the
training views under the FINAL render config (softmax and mask
sharpness, coverage family, pixel-area mask, pixel angle, culling). The
JAX CLI's best-of evaluation (burn_raymarching_tpu/tools/train_cli.py:
352-360) passes the sharpness and culling but leaves the coverage family
and the pixel-area mask at their defaults. The two agree at the default
render settings, and there the port's gate is held to the JAX CLI's call
on the same scene and views; under a Gaussian coverage the JAX CLI would
rank seeds by a forward other than the one trained and exported, and the
port's gate follows the final config instead (a recorded divergence).

Tolerance: 0.01 dB between the two packages' PSNR of the same scene (each
view's PSNR is taken on 8-bit encodings, where a float32 rounding may move
a pixel by one level).
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_params, nn

from burn_raymarching_tpu.ops.march import march_xla
from burn_raymarching_tpu.train.evaluate import evaluate_views as j_eval
from burn_raymarching_tpu_torch.data.image_io import load_image_as_array
from burn_raymarching_tpu_torch.data.scene_io import load_cameras
from burn_raymarching_tpu_torch.models.scene import (
    PARAM_KEYS,
    init_scene_params,
    pad_params,
)
from burn_raymarching_tpu_torch.tools import generate, train_cli
from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

SIZE = 32


@pytest.fixture(scope="module")
def dango(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bestof") / "data")
    generate.main(["--out", out, "--size", str(SIZE), "--device", "cpu"])
    return os.path.join(out, "cameras.json")


def _config(cameras, *flags):
    return train_cli.build_config(train_cli.make_parser().parse_args(
        ["--cameras", cameras, "--width", str(SIZE), "--height", str(SIZE),
         "--no-pallas", *flags]))


def _scene():
    """The reference init with spread centers and varied colours."""
    p = init_scene_params(7, device="cpu")
    rng = np.random.default_rng(3)
    with torch.no_grad():
        p.centers.mul_(2.5)
        p.colors.copy_(torch.as_tensor(rng.normal(0, 1.5, (7, 3)),
                                       dtype=p.colors.dtype))
        p.radii.fill_(-1.5)
    return pad_params(p, 8)


def _gates(cfg):
    """(the port's best-of gate, the JAX CLI's best-of call, the JAX
    evaluator under the full final render config) on one scene."""
    trainer = Trainer(cfg, build_dataset(cfg, device="cpu"),
                      log=lambda s: None)
    padded, mask = _scene()
    port = trainer.views_psnr(padded, mask)
    cams = load_cameras(cfg.cameras_json)
    tgts = [load_image_as_array(c["file"]) for c in cams]
    jp = jax_params({k: nn(getattr(padded, k)) for k in PARAM_KEYS})
    rc = cfg.render
    cli = dict(smooth_k=cfg.max_smooth_k, march_fn=march_xla,
               march_normal_fn=None, softmax_sharpness=rc.softmax_sharpness,
               mask_sharpness=rc.mask_sharpness, cull=None)
    args = (jp, cams, tgts, cfg.width, cfg.height)
    m = jnp.asarray(nn(mask))
    jax_cli = j_eval(*args, mask=m, **cli)["mean"]
    jax_final = j_eval(*args, mask=m, mask_pixel_mult=rc.mask_pixel_mult,
                       pixel_angle=rc.pixel_angle,
                       coverage_mode=rc.coverage_mode, **cli)["mean"]
    return port, jax_cli, jax_final


def test_gate_agrees_with_the_jax_cli_at_default_render(dango):
    port, jax_cli, jax_final = _gates(_config(dango))
    assert jax_cli == jax_final
    assert abs(port - jax_cli) < 0.01
    assert 10.0 < port < 60.0


def test_gate_follows_the_final_render_config(dango):
    """Gaussian coverage with a pixel-area mask: the port's gate equals the
    JAX evaluator under the final config and differs from the JAX CLI's
    call, which leaves those at their defaults."""
    pixel_angle = float(2.0 * np.tan(np.radians(25.0)) / SIZE)
    port, jax_cli, jax_final = _gates(_config(
        dango, "--coverage", "gaussian", "--sharp", "10,40", "--mask-px",
        "1.5", "--pixel-angle", repr(pixel_angle)))
    assert abs(port - jax_final) < 0.01
    assert abs(port - jax_cli) > 0.1


def test_best_of_keeps_the_seed_with_the_best_gate(dango, tmp_path,
                                                   monkeypatch):
    """train_cli --best-of 3 runs three seeds, gates each with
    views_psnr under the final render config, and returns the best."""
    seen = []
    gate = Trainer.views_psnr

    def record(self, padded, mask, *a, **kw):
        value = gate(self, padded, mask, *a, **kw)
        seen.append((self.cfg.seed, self.cfg.render, value))
        return value

    monkeypatch.setattr(Trainer, "views_psnr", record)
    trainer, _, _ = train_cli.main([
        "--cameras", dango, "--width", str(SIZE), "--height", str(SIZE),
        "--stages", "1", "--steps", "3", "--batch", "256", "--best-of", "3",
        "--coverage", "gaussian", "--sharp", "10,40",
        "--scene-out", str(tmp_path / "scene.json"),
        "--steps-dir", str(tmp_path / "steps"), "--device", "cpu"])
    final = dataclasses.replace(_config(dango).render,
                                coverage_mode="gaussian", mask_sharpness=40.0)
    assert [s for s, _, _ in seen] == [0, 1, 2]
    assert all(render == final for _, render, _ in seen)
    assert trainer.cfg.seed == max(seen, key=lambda x: x[2])[0]
    assert (tmp_path / "scene.json").exists()

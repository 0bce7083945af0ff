"""compute_loss (value and gradients) and the Adam optimizer of the port
against the JAX package (loss) and optax (make_optimizer)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_params, nn, pad_raw, random_raw_params, tt

from burn_raymarching_tpu.config import LossConfig, TrainConfig
from burn_raymarching_tpu.train.loss import compute_loss as j_loss
from burn_raymarching_tpu.train.optimizer import make_optimizer as j_opt
from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS, params_from_numpy
from burn_raymarching_tpu_torch.train.loss import compute_loss
from burn_raymarching_tpu_torch.train.optimizer import (
    make_optimizer,
    set_group_lrs,
)


def _loss_inputs(seed, m, pad):
    rng = np.random.default_rng(seed)
    raw = random_raw_params(seed, m)
    # Exercise every branch: radii > 1, centers beyond the proximity bound.
    raw["radii"][0] = 1.5
    raw["centers"][1] = [1.1, 0.2, 0.0]
    raw = pad_raw(raw, pad) if pad else raw
    mask = (np.arange(m + pad) < m) if pad else None
    out = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    tgt = (rng.uniform(0, 1, (256, 3))
           * (rng.uniform(0, 1, (256, 1)) > 0.6)).astype(np.float32)
    return raw, mask, out, tgt


@pytest.mark.parametrize("pad,fringe", [(0, 1.0), (3, 1.0), (3, 2.5)])
def test_compute_loss_value_and_gradients(pad, fringe):
    raw, mask, out, tgt = _loss_inputs(3, 6, pad)
    cfg = LossConfig(fringe_weight=fringe)
    progress = 0.37

    def jl(p, o):
        return j_loss(p, o, jnp.asarray(tgt), jnp.float32(progress),
                      mask=None if mask is None else jnp.asarray(mask),
                      cfg=cfg)
    val_j, (gp_j, go_j) = jax.value_and_grad(jl, argnums=(0, 1))(
        jax_params(raw), jnp.asarray(out))

    p = params_from_numpy(raw, device="cpu")
    o = tt(out).requires_grad_(True)
    val_t = compute_loss(p, o, tt(tgt), progress,
                         mask=None if mask is None else tt(mask), cfg=cfg)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-6)
    np.testing.assert_allclose(nn(o.grad), np.asarray(go_j), rtol=1e-6,
                               atol=1e-9)
    grads = {name: (np.zeros_like(raw[name]) if getattr(p, name).grad is None
                    else nn(getattr(p, name).grad)) for name in PARAM_KEYS}
    for name in PARAM_KEYS:   # colors/light/ambient: no loss term → 0
        np.testing.assert_allclose(grads[name],
                                   np.asarray(getattr(gp_j, name)),
                                   rtol=1e-5, atol=1e-8, err_msg=name)
    if pad:
        for name in ("centers", "radii"):
            np.testing.assert_array_equal(grads[name][6:], 0.0)


@pytest.mark.parametrize("mode", ["folded", "decoupled"])
def test_adam_trajectory_matches_optax(mode):
    cfg = TrainConfig(weight_decay_mode=mode, weight_decay=1e-2,
                      lr_scale_centers=0.5, lr_scale_radii=0.25)
    scales = {"centers": 0.5, "colors": 1.0, "radii": 0.25,
              "light_dir": 1.0, "ambient": 1.0}
    raw = random_raw_params(7, 5)
    rng = np.random.default_rng(8)
    steps = 10
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in raw.items()} for _ in range(steps)]
    lrs = [0.05 if i < 5 else 0.01 for i in range(steps)]

    tx = j_opt(cfg)
    pj = jax_params(raw)
    state = tx.init(pj)
    pt = params_from_numpy(raw, device="cpu")
    opt = make_optimizer(cfg, pt)
    for g, lr in zip(grads, lrs):
        upd, state = tx.update(jax_params(g), state, pj)
        pj = jax.tree.map(lambda p, u, s: p - lr * s * u, pj, upd,
                          jax_params({k: np.float32(scales[k])
                                      for k in raw}))
        for k in PARAM_KEYS:
            getattr(pt, k).grad = torch.as_tensor(g[k])
        set_group_lrs(opt, lr, scales)
        opt.step()
        # torch applies the step as one addcdiv, optax as p - lr*s*u: the
        # two round differently, ~1 ulp of |p| <= 3 (3e-7) per step.
        for k in PARAM_KEYS:
            np.testing.assert_allclose(nn(getattr(pt, k)),
                                       np.asarray(getattr(pj, k)),
                                       rtol=1e-5, atol=5e-6, err_msg=k)


def test_unknown_weight_decay_mode_raises():
    cfg = dataclasses.replace(TrainConfig(), weight_decay_mode="bogus")
    with pytest.raises(ValueError):
        make_optimizer(cfg, params_from_numpy(random_raw_params(0, 2),
                                              device="cpu"))

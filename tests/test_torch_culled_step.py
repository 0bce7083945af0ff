"""The culled training step with hierarchical selection and the monopole
far field, against the JAX package's own step body (modelled on
tests/test_culled_training.py and tests/test_torch_train.py's config-4
step test): the same tile ids are injected into both samplers and the same
t cache into both warm starts; the loss and the parameters after each
Adam step are compared at each of two steps, every gradient at the first
(from the same parameters: later ones start from parameters that already
differ by float32 rounding, which the light gradient amplifies).

Setup: 600 prior-seeded spheres in 1,024 slots, clusters of 8 (75 live),
cluster budget 32 (config 5's), so selection keeps 32 of the clusters per
tile and then the per-tile top-K over their members; K = 256 holds those
32 × 8 candidates, so no overflowing tile's cut falls between scores that
float32 rounding orders differently. Both steps march through the JAX
package's culled_march_normals_xla (the port's march is held to it in
tests/test_torch_culled.py), so this test holds the step's wiring.

Tolerances (float32, two implementations of the same sums): loss rtol
1e-4; gradients rtol 1e-3 with atol 1e-3 of each group's largest entry
(near-miss rays keep coverage ~1e-3 while their normals are rounding-noise
directions, as tests/test_torch_culled.py states for the renderer);
parameters after each Adam step atol 1e-4, as the config-4 step test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_params, nn, tiny_knot_dataset

from burn_raymarching_tpu.train.optimizer import make_optimizer as j_opt
from burn_raymarching_tpu.train.step_body import lr_scale_tree as j_scales
from burn_raymarching_tpu_torch.models.scene import PARAM_KEYS, pad_params
from burn_raymarching_tpu_torch.train.optimizer import (
    make_optimizer,
    set_group_lrs,
)
from burn_raymarching_tpu_torch.train.step_body import (
    lr_scale_tree,
    make_device_step,
)

STEPS = 2


@pytest.fixture(scope="module")
def knot(tmp_path_factory):
    return str(tmp_path_factory.mktemp("knot_hier") / "data")


@pytest.mark.parametrize("hier,far_field", [(True, "monopole"),
                                            (True, "member"),
                                            (False, "monopole")])
def test_culled_steps_match_jax(knot, monkeypatch, hier, far_field):
    import burn_raymarching_tpu.train.step_body as jsb
    from burn_raymarching_tpu.ops.culling import PrimitiveClusters
    from burn_raymarching_tpu.ops.march import march_xla
    from burn_raymarching_tpu.render.culled import culled_march_normals_xla
    from burn_raymarching_tpu.train.loss import build_repulsion_static as jst
    from burn_raymarching_tpu_torch.config import LossConfig
    from burn_raymarching_tpu_torch.ops.culling import build_clusters
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static

    cfg, arrays, ds, _ = tiny_knot_dataset(
        knot, cull_tile=128, cull_budget=256, batch=512, init_n=600,
        cull_hierarchical=hier, cull_cluster_budget=32,
        loss=LossConfig(repulsion_far_field=far_field))
    packed = np.concatenate(arrays, axis=1).astype(np.float32)
    n_tiles = packed.shape[0] // cfg.cull_tile
    rng = np.random.default_rng(7)
    tids = [rng.integers(0, n_tiles, 4).astype(np.int32)
            for _ in range(STEPS)]
    t_cache0 = rng.uniform(1.0, 2.5, packed.shape[0]).astype(np.float32)
    stage = 1

    pt, mask_t = pad_params(Trainer(cfg, ds, log=lambda s: None)
                            ._init_params(), 1024)
    raw = {k: nn(getattr(pt, k)) for k in PARAM_KEYS}
    mask = nn(mask_t)
    cl_t = build_clusters(raw["centers"], mask=mask, group=8, device="cpu")
    assert cl_t.member_idx.shape[0] > cfg.cull_cluster_budget

    calls = iter(tids)
    monkeypatch.setattr(jsb, "sample_batch_indices",
                        lambda *a, **kw: jnp.asarray(next(calls)))
    step_j = jsb.make_device_step(
        cfg, march_fn=march_xla, march_normal_fn=None, culled_march_fn=None,
        repulsion_fn=None, batch=cfg.batch_size, warm=True)
    pj = jax_params(raw)
    tx = j_opt(cfg)
    st = tx.init(pj)
    cl_j = PrimitiveClusters(jnp.asarray(nn(cl_t.member_idx), jnp.int32),
                             jnp.asarray(nn(cl_t.member_valid)))
    mask_j = jnp.asarray(mask)
    static_j = jst(pj.centers, cl_j, mask_j)
    cache_j = jnp.asarray(t_cache0)

    def jax_march(*args, t_init=None, **kw):
        t, n = culled_march_normals_xla(
            *(jnp.asarray(nn(a)) if torch.is_tensor(a) else a for a in args),
            t_init=None if t_init is None else jnp.asarray(nn(t_init)), **kw)
        return torch.tensor(np.asarray(t)), torch.tensor(np.asarray(n))

    step_t = make_device_step(cfg, march_normal_fn=None,
                              batch=cfg.batch_size, culled_march_fn=jax_march,
                              warm=True)
    opt = make_optimizer(cfg, pt)
    static_t = build_repulsion_static(pt.centers, cl_t, mask_t)
    cache_t = torch.as_tensor(t_cache0.copy())
    fg = torch.zeros(n_tiles, dtype=torch.int32)

    for step, tid in enumerate(tids, start=1):
        loss_j, g_j, cache_j, lr = step_j(
            pj, jax.random.PRNGKey(0), jnp.int32(step - 1),
            jnp.int32(stage), jnp.int32(0), mask_j, jnp.asarray(packed),
            jnp.zeros(n_tiles, jnp.int32), jnp.int32(0), cache_j,
            cl_j.member_idx, cl_j.member_valid, rep_static=static_j)
        upd, st = tx.update(g_j, st, pj)
        pj = jax.tree.map(lambda p, u, s: p - lr * s * u, pj, upd,
                          j_scales(cfg))

        idx = (torch.as_tensor(tid).long()[:, None] * cfg.cull_tile
               + torch.arange(cfg.cull_tile)).reshape(-1)
        loss_t, lr_t = step_t(pt, None, stage, step, mask_t,
                              torch.as_tensor(packed), fg, 0, idx=idx,
                              t_cache=cache_t, clusters=cl_t,
                              rep_static=static_t)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
        for name in PARAM_KEYS if step == 1 else ():
            want = np.asarray(getattr(g_j, name))
            np.testing.assert_allclose(
                nn(getattr(pt, name).grad), want, rtol=1e-3,
                atol=1e-3 * np.abs(want).max(),
                err_msg=f"grad {name} @ {step}")
        set_group_lrs(opt, lr_t, lr_scale_tree(cfg))
        opt.step()
        for name in PARAM_KEYS:
            np.testing.assert_allclose(nn(getattr(pt, name)),
                                       np.asarray(getattr(pj, name)),
                                       atol=1e-4, err_msg=f"{name} @ {step}")
    assert not np.array_equal(nn(cache_t), t_cache0)

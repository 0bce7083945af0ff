"""render_diff (values and gradients), adaptive_coverage, render_gt and
create_camera_rays of the port against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    DANGO_CENTERS,
    DANGO_COLORS,
    DANGO_RADII,
    jax_params,
    nn,
    pad_raw,
    random_raw_params,
    tt,
)

from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.models.scene import scene_forward as j_forward
from burn_raymarching_tpu.render.diff import adaptive_coverage as j_cov
from burn_raymarching_tpu.render.gt import render_gt as j_gt
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.models.scene import (
    params_from_numpy,
    scene_forward,
)
from burn_raymarching_tpu_torch.render.diff import adaptive_coverage
from burn_raymarching_tpu_torch.render.gt import render_gt

GROUPS = ("centers", "colors", "radii", "light_dir", "ambient")


@pytest.mark.parametrize("w,h,eye,fov", [
    (16, 8, [0.0, 0.5, -2.5], 50.0),
    (12, 12, [2.5, 0.5, 0.0], 35.0),
    (8, 8, [0.0, 2.5, -0.001], 50.0),      # the rig's top view
])
def test_camera_rays_match_jax(w, h, eye, fov):
    ro_j, rd_j = j_rays(w, h, eye, [0.0, 0.0, 0.0], fov)
    ro_t, rd_t = create_camera_rays(w, h, eye, [0.0, 0.0, 0.0], fov,
                                    device="cpu")
    np.testing.assert_array_equal(nn(ro_t), np.asarray(ro_j))
    np.testing.assert_allclose(nn(rd_t), np.asarray(rd_j), rtol=1e-6,
                               atol=1e-7)


def test_render_gt_matches_jax():
    ro, rd = (np.asarray(x) for x in
              j_rays(16, 16, [0.0, 0.3, -1.2], [0, 0, 0], 50.0))
    args_j = [jnp.asarray(x) for x in (ro, rd, DANGO_CENTERS, DANGO_COLORS,
                                       DANGO_RADII)]
    args_t = [tt(x) for x in (ro, rd, DANGO_CENTERS, DANGO_COLORS,
                              DANGO_RADII)]
    want = np.asarray(j_gt(*args_j))
    got = nn(render_gt(*args_t))
    assert want.max() > 0.2
    # Grazing rays carry the 40-step march's ulp growth (worst seen 9e-5),
    # far below one 8-bit level of the saved targets (~4e-3).
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("mode,mult", [("sigmoid", 0.0), ("sigmoid", 1.5),
                                       ("gaussian", 0.0), ("gaussian", 1.5)])
def test_adaptive_coverage_matches_jax(mode, mult):
    rng = np.random.default_rng(4)
    d = rng.normal(0, 0.1, (64, 1)).astype(np.float32)
    t = rng.uniform(1, 4, (64, 1)).astype(np.float32)
    want = j_cov(jnp.asarray(d), jnp.asarray(t), 15.0, mult, 0.01, mode)
    got = adaptive_coverage(tt(d), tt(t), 15.0, mult, 0.01, mode)
    np.testing.assert_allclose(nn(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("pad", [0, 3])
def test_render_diff_values_and_gradients_match_jax(pad):
    m = 5
    raw = random_raw_params(11, m)
    raw["centers"] *= 0.5
    if pad:
        raw = pad_raw(raw, pad)
    mask = (np.arange(m + pad) < m) if pad else None
    ro, rd = (np.asarray(x) for x in
              j_rays(12, 12, [0.0, 0.3, -1.5], [0, 0, 0], 50.0))
    cot = np.random.default_rng(5).normal(0, 1, (ro.shape[0], 3)).astype(
        np.float32)

    def jloss(p):
        out = j_forward(p, jnp.asarray(ro), jnp.asarray(rd), 24.0,
                        mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, out_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jax_params(raw))
    p = params_from_numpy(raw, device="cpu")
    out_t = scene_forward(p, tt(ro), tt(rd), 24.0,
                          mask=None if mask is None else tt(mask))
    (out_t * tt(cot)).sum().backward()
    assert float(np.asarray(out_j).max()) > 0.05
    np.testing.assert_allclose(nn(out_t), np.asarray(out_j), rtol=1e-4,
                               atol=1e-5)
    for name in GROUPS:
        np.testing.assert_allclose(nn(getattr(p, name).grad),
                                   np.asarray(getattr(g_j, name)),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    if pad:
        for name in ("centers", "colors", "radii"):
            np.testing.assert_array_equal(nn(getattr(p, name).grad)[m:], 0.0)


def test_gradient_topology_one_reattached_eval():
    """Freezing the march (t fixed) leaves the gradient unchanged: no
    gradient flows through the march iterations or the normals."""
    from burn_raymarching_tpu_torch.ops.march import march
    from burn_raymarching_tpu_torch.render.diff import render_diff

    raw = random_raw_params(12, 4)
    p = params_from_numpy(raw, device="cpu")
    ro, rd = create_camera_rays(8, 8, [0.0, 0.3, -1.5], [0, 0, 0], 50.0,
                                device="cpu")
    from burn_raymarching_tpu_torch.models.scene import activate

    def grads(march_fn):
        for q in p.parameters():
            q.grad = None
        c, col, r, ld, amb = activate(p)
        render_diff(ro, rd, c, col, r, ld, amb, 24.0,
                    march_fn=march_fn).sum().backward()
        return [q.grad.clone() for q in p.parameters()]

    with torch.no_grad():
        c, _, r, _, _ = activate(p)
        t_frozen = march(ro, rd, c, r, 24.0)
    g_live = grads(march)
    g_frozen = grads(lambda *a, **kw: t_frozen)
    for a, b in zip(g_live, g_frozen):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

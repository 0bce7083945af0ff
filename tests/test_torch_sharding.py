"""The port's sharded functions (model axis, data axis) against the JAX
package's, on several gloo ranks on the CPU.

Inputs are made with numpy from a seed and go through both packages: the
JAX functions unsharded and under shard_map on the conftest's 8-device CPU
mesh (as tests/test_sharding.py runs them), the port's on 2 or 4 spawned
ranks (tests/torch_dist.py), at (data, model) = (1, 2), (1, 4), (2, 1) and
(2, 2). The port's values are held against the JAX function that shards
the same way, and its gradients against the JAX package's unsharded
gradients: under shard_map with check_vma=False, the JAX package's own
sharded gradients come out model-size times too large (its psum transposes
to a psum), which ``test_jax_sharded_gradients_carry_the_model_size`` pins.

Tolerances, each no wider than tests/test_sharding.py's for the same
comparison: dense render rtol 5e-3 / atol 5e-4, culled render rtol 8e-3 /
atol 1e-3 (sharded sums reassociate, and the 40-step march amplifies
few-ulp differences on grazing rays); loss rtol 1e-5; gradients rtol 5e-3
with atol 1e-6 (the data-parallel test's);
union-table march t rtol/atol 2e-5, normals on hit rays atol 1e-3. The
float64 yardstick beside them: the same sharded code in float64 against
the unsharded code in float64 agrees to 1e-10, so every gap above is
float32 rounding, not a difference of the function.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist
from jax.sharding import PartitionSpec as P
from torch_parity import cuda_device, nn, tt  # noqa: F401  (a fixture)

from burn_raymarching_tpu.models.scene import SceneParams as JParams
from burn_raymarching_tpu.models.scene import scene_forward as j_forward
from burn_raymarching_tpu.parallel.mesh import make_mesh as j_mesh
from burn_raymarching_tpu.parallel.train_step import param_specs as j_specs
from burn_raymarching_tpu.render.culled import (
    culled_march_normals_xla as j_culled_march,
)
from burn_raymarching_tpu.render.culled import render_diff_culled as j_culled
from burn_raymarching_tpu.train.loss import cluster_repulsion as j_rep
from burn_raymarching_tpu.train.loss import compute_loss as j_loss
from burn_raymarching_tpu_torch.data.camera import create_camera_rays

KEYS = ("centers", "colors", "radii", "light_dir", "ambient")
M, LIVE, K, TILE, GROUP = 8, 7, 32.0, 16, 2
CONFIGS = [(1, 2), (1, 4), (2, 1), (2, 2)]


@functools.cache
def inputs() -> dict:
    rng = np.random.default_rng(0)
    ro, rd = (x.numpy() for x in create_camera_rays(
        16, 16, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0], 50.0))
    f32 = np.float32
    inp = {
        "centers": rng.normal(0, 0.3, (M, 3)).astype(f32),
        "colors": rng.normal(0, 1, (M, 3)).astype(f32),
        "radii": rng.normal(-1, 0.3, (M, 1)).astype(f32),
        "light_dir": np.asarray([0.1, 1.0, -0.2], f32),
        "ambient": np.asarray([-1.4], f32),
        "mask": np.arange(M) < LIVE,
        "ro": ro, "rd": rd,
        "tgt": rng.uniform(0, 1, (256, 3)).astype(f32),
        "cot": rng.normal(0, 1, (256, 3)).astype(f32),
        "loss_out": np.zeros((32, 3), f32),
        "loss_tgt": np.full((32, 3), 0.2, f32),
        "k": K, "tile": TILE, "group": GROUP,
    }
    inp["radii_phys"] = (np.log1p(np.exp(inp["radii"])) + 0.01).astype(f32)
    return inp


def _with_budget(model: int) -> dict:
    # Per-shard budget = the shard's rows: every shard keeps all of them,
    # so the culled render differs from the dense one only in reduction
    # order (tests/test_sharding.py's choice).
    return {**inputs(), "k_budget": M // model}


@functools.cache
def _port(data: int, model: int, dtype: str, tmp: str):
    import pathlib

    return torch_dist.run_ranks(
        pathlib.Path(tmp), data * model, torch_dist.sharded_functions, data,
        model, _with_budget(model), dtype)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded"))
    return lambda data, model, dtype="float32": _port(data, model, dtype, tmp)


def _rows(results, data: int, model: int, key: str) -> np.ndarray:
    """A row-sharded result reassembled: model ranks' rows in order (data
    ranks hold equal copies after the gradient mean)."""
    return np.concatenate([results[m][key] for m in range(model)])


def _per_ray(results, data: int, model: int, key: str) -> np.ndarray:
    """A per-ray result reassembled over the data ranks."""
    return np.concatenate([results[d * model][key] for d in range(data)])


def _grads(results, data, model, name) -> dict:
    return {k: (_rows(results, data, model, f"{name}_grad_{k}")
                if k in KEYS[:3] else results[0][f"{name}_grad_{k}"])
            for k in KEYS}


def _jparams():
    return JParams(**{k: jnp.asarray(inputs()[k]) for k in KEYS})


def _jarr(key):
    return jnp.asarray(inputs()[key])


def _assert_grads(got: dict, want, label: str):
    for k in KEYS:
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=1e-6,
                                   err_msg=f"{label} {k}")


def _j_render_grads():
    mask, ro, rd, cot = (_jarr(k) for k in ("mask", "ro", "rd", "cot"))

    def f(p):
        out = j_forward(p, ro, rd, K, mask=mask)
        return jnp.sum(out * cot) / ro.shape[0], out

    (_, out), g = jax.value_and_grad(f, has_aux=True)(_jparams())
    return np.asarray(out), g


def _j_sharded(fn, model: int, in_specs, out_specs):
    return jax.shard_map(fn, mesh=j_mesh(data=1, model=model),
                         in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


@pytest.mark.parametrize("data,model", CONFIGS)
def test_render_matches_jax(port, data, model):
    res = port(data, model)
    want, g_want = _j_render_grads()
    got = _per_ray(res, data, model, "render")
    assert want.max() > 0.05
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    if model > 1:
        mask, ro, rd = (_jarr(k) for k in ("mask", "ro", "rd"))
        j_sh = _j_sharded(
            lambda p, m: j_forward(p, ro, rd, K, mask=m, model_axis="model"),
            model, (j_specs(True), P("model")), P(None, None))
        np.testing.assert_allclose(got, np.asarray(j_sh(_jparams(), mask)),
                                   rtol=5e-3, atol=5e-4)
    _assert_grads(_grads(res, data, model, "render"), g_want, "render")


@pytest.mark.parametrize("data,model", CONFIGS)
def test_loss_matches_jax(port, data, model):
    res = port(data, model)
    mask, out, tgt = (_jarr(k) for k in ("mask", "loss_out", "loss_tgt"))
    want, g_want = jax.value_and_grad(
        lambda p: j_loss(p, out, tgt, jnp.float32(0.4), mask))(_jparams())
    for r in res:
        np.testing.assert_allclose(r["loss"], float(want), rtol=1e-5)
    _assert_grads(_grads(res, data, model, "loss"), g_want, "loss")


@pytest.mark.parametrize("data,model", CONFIGS)
def test_training_objective_gradients_match_jax(port, data, model):
    """render → loss over the whole batch: the data ranks' averaged
    gradients are the full batch's (JAX test_dp_gradients_match_replicated)
    and the model ranks' rows are its rows."""
    res = port(data, model)
    mask, ro, rd, tgt = (_jarr(k) for k in ("mask", "ro", "rd", "tgt"))
    want, g_want = jax.value_and_grad(lambda p: j_loss(
        p, j_forward(p, ro, rd, K, mask=mask), tgt, jnp.float32(0.5),
        mask))(_jparams())
    for r in res:
        np.testing.assert_allclose(r["step_loss"], float(want), rtol=1e-5)
    _assert_grads(_grads(res, data, model, "step"), g_want, "step")


@pytest.mark.parametrize("data,model", CONFIGS)
def test_culled_render_matches_jax(port, data, model):
    res = port(data, model)
    mask, ro, rd, cot = (_jarr(k) for k in ("mask", "ro", "rd", "cot"))

    def act(p):
        return (p.centers, jax.nn.sigmoid(p.colors),
                jax.nn.softplus(p.radii) + 0.01, p.light_dir,
                jax.nn.sigmoid(p.ambient))

    def f(p, budget, axis=None, m=mask):
        return j_culled(ro, rd, *act(p), K, mask=m, tile=TILE,
                        k_budget=budget, model_axis=axis)

    # Gradient reference: the unsharded culled render keeping all M rows.
    (_, want), g_want = jax.value_and_grad(
        lambda p: (jnp.sum(f(p, M) * cot) / ro.shape[0], f(p, M)),
        has_aux=True)(_jparams())
    got = _per_ray(res, data, model, "culled")
    assert np.asarray(want).max() > 0.05
    np.testing.assert_allclose(got, np.asarray(want), rtol=8e-3, atol=1e-3)
    if model > 1:
        j_sh = _j_sharded(lambda p, m: f(p, M // model, "model", m), model,
                          (j_specs(True), P("model")), P(None, None))
        np.testing.assert_allclose(got, np.asarray(j_sh(_jparams(), mask)),
                                   rtol=8e-3, atol=1e-3)
    _assert_grads(_grads(res, data, model, "culled"), g_want, "culled")


def _j_rep_sharded(model: int, far: str):
    """JAX's sharded cluster repulsion: value and (its own) gradient."""
    g = GROUP
    n_valid = jnp.float32(LIVE)

    def fn(c_l, m_l):
        m_local = c_l.shape[0]
        from burn_raymarching_tpu.ops.culling import PrimitiveClusters

        cl = PrimitiveClusters(
            jnp.arange(m_local, dtype=jnp.int32).reshape(-1, g),
            jnp.ones((m_local // g, g), bool))

        def v(c):
            return j_rep(c, cl, m_l, n_valid, near_clusters=2,
                         model_axis="model", far_field=far)

        return jax.value_and_grad(v)(c_l)

    return _j_sharded(fn, model, (P("model", None), P("model")),
                      (P(), P("model", None)))(_jarr("centers"),
                                               _jarr("mask"))


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("far", ["member", "monopole"])
def test_cluster_repulsion_matches_jax(port, model, far):
    """The sharded two-level repulsion (near field within a shard's own
    clusters, every other cluster a monopole through the gathered
    centroids): value against JAX's sharded function to 1e-5, gradient
    against JAX's sharded gradient divided by the model size."""
    res = port(1, model)
    value, grad = _j_rep_sharded(model, far)
    for r in res:
        np.testing.assert_allclose(r[f"rep_{far}"], float(value), rtol=1e-5)
    got = _rows(res, 1, model, f"rep_{far}_grad")
    want = np.asarray(grad) / model
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("model", [2, 4])
def test_jax_sharded_gradients_carry_the_model_size(port, model):
    """JAX's shard_map (check_vma=False) transposes psum to psum, so its
    sharded render gradients are model-size times the unsharded ones; the
    port's collectives transpose a replicated psum to the identity and
    enter the shard's terms through pvary, and its gradients carry no such
    factor."""
    mask, ro, rd, cot = (_jarr(k) for k in ("mask", "ro", "rd", "cot"))

    def dev(p, m):
        return jax.grad(lambda q: jnp.sum(j_forward(
            q, ro, rd, K, mask=m, model_axis="model") * cot)
            / ro.shape[0])(p)

    g_sh = _j_sharded(dev, model, (j_specs(True), P("model")),
                      j_specs(True))(_jparams(), mask)
    _, g_want = _j_render_grads()
    got = _grads(port(1, model), 1, model, "render")
    for k in ("centers", "colors", "radii"):
        w = np.asarray(getattr(g_want, k))
        np.testing.assert_allclose(np.asarray(getattr(g_sh, k)), model * w,
                                   rtol=5e-3, atol=1e-6 * np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=1e-6)


@pytest.mark.parametrize("data,model", [(1, 4), (2, 2)])
def test_float64_yardstick(port, data, model):
    """The sharded code in float64 against the unsharded port in float64:
    agreement to 1e-10 shows that the float32 gaps the other tests allow
    are rounding, not a different function."""
    from burn_raymarching_tpu_torch.models.scene import scene_forward
    from burn_raymarching_tpu_torch.train.loss import compute_loss

    res = port(data, model, "float64")
    inp = inputs()
    leaves = torch_dist.Leaves(**{k: tt(inp[k]).double().requires_grad_()
                                  for k in KEYS})
    mask = tt(inp["mask"])
    ro, rd, tgt, cot = (tt(inp[k]).double() for k in ("ro", "rd", "tgt",
                                                       "cot"))
    out = scene_forward(leaves, ro, rd, K, mask=mask)
    np.testing.assert_allclose(_per_ray(res, data, model, "render"),
                               nn(out), rtol=1e-10, atol=1e-12)
    compute_loss(leaves, scene_forward(leaves, ro, rd, K, mask=mask), tgt,
                 0.5, mask=mask).backward()
    got = _grads(res, data, model, "step")
    for k in KEYS:
        want = nn(getattr(leaves, k).grad)
        np.testing.assert_allclose(got[k], want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=k)
    del cot


@functools.cache
def _union(model: int, warm: bool, tmp: str):
    import pathlib

    b = 256 // TILE
    t_init = (np.full((b, TILE, 1), 0.5, np.float32) if warm else None)
    return torch_dist.run_ranks(
        pathlib.Path(tmp), model, torch_dist.union_march, model,
        _with_budget(model), t_init)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("warm", [False, True])
def test_union_table_march(tmp_path_factory, model, warm):
    """train/step_body.sharded_culled_kernel_march (one all_to_all of the
    shard tables, the K3 wrapper on the union [B/S, S·K] table, one
    all_gather) against the plain sharded march (pmax/psum at every step),
    and both against JAX's sharded XLA twin on the same shard tables (JAX
    test_sharded_kernel_march_matches_xla_twin / _warm_start)."""
    from burn_raymarching_tpu.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )

    res = _union(model, warm, str(tmp_path_factory.mktemp("union")))
    inp = _with_budget(model)
    b = 256 // TILE
    t_init = (jnp.full((b, TILE, 1), 0.5, jnp.float32) if warm else None)
    steps = 16 if warm else 40
    ro, rd = jnp.asarray(inp["ro"]), jnp.asarray(inp["rd"])

    def dev(c_l, r_l, m_l):
        idx, valid = select_tile_primitives(
            tile_cones(ro, rd, TILE), c_l, r_l, jnp.float32(K),
            inp["k_budget"], mask=m_l)
        cs = jnp.take(c_l, idx, axis=0)
        rs = jnp.take(r_l.reshape(-1), idx, axis=0)
        qs = jnp.where(valid, jnp.sum(cs * cs, axis=2), 1e30)
        return j_culled_march(ro.reshape(b, TILE, 3), rd.reshape(b, TILE, 3),
                              cs, rs, qs, jnp.float32(K), num_steps=steps,
                              t_init=t_init, model_axis="model")

    r3 = P(None, None, None)
    t_j, n_j = (np.asarray(x) for x in _j_sharded(
        dev, model, (P("model", None), P("model", None), P("model")),
        (r3, r3))(jnp.asarray(inp["centers"]), jnp.asarray(inp["radii_phys"]),
                  jnp.asarray(inp["mask"])))
    hit = t_j[..., 0] < 5.0
    assert hit.any()
    for r in res:
        for got_t, got_n in ((r["t_union"], r["n_union"]),
                             (r["t_plain"], r["n_plain"])):
            np.testing.assert_allclose(got_t, t_j, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got_n[hit], n_j[hit], atol=1e-3)
        np.testing.assert_allclose(r["t_union"], r["t_plain"], rtol=2e-5,
                                   atol=2e-5)


def test_collective_transposes(tmp_path):
    """The loss y + z is replicated; every rank back-propagates its copy.
    d/dx_r = w (psum: identity) + w (all_gather: own slice); d/dw = sum of
    every x (pvary's backward sums the ranks' parts) + sum of every x (z is
    replicated): no factor of the rank count anywhere."""
    res = torch_dist.run_ranks(tmp_path, 2, torch_dist.collective_grads)
    xs = np.asarray([1.0, 2.0, 2.0, 3.0])
    for r in res:
        np.testing.assert_allclose(r["x_grad"], [6.0, 6.0])
        assert r["w_grad"] == pytest.approx(2 * xs.sum())
        assert r["value"] == pytest.approx(2 * 3.0 * xs.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_cuda_union_table_march_through_k3(cuda_device, tmp_path, warm):
    """The union-table march launches K3 on the [B/S, S·K] union table (2
    gloo ranks sharing the card): against the plain version on the same
    tables, each gap held to 5× the plain version's own gap to the float64
    march plus 1e-5, as tests/test_torch_culled.py holds K3."""
    b = 256 // TILE
    t_init = np.full((b, TILE, 1), 0.5, np.float32) if warm else None
    res = torch_dist.run_ranks(tmp_path, 2, torch_dist.union_march_cuda,
                               _with_budget(2), t_init)
    for r in res:
        assert r["launches"] == 1
        hit = r["t_64"][..., 0] < 10.0
        assert hit.any()
        for key, noise_key, ref in (("t_k", "t_64", "t_p"),
                                    ("n_k", "n_64", "n_p")):
            noise = np.abs(r[ref][hit] - r[noise_key][hit]).max()
            gap = np.abs(r[key][hit] - r[ref][hit]).max()
            assert gap <= 5.0 * noise + 1e-5, (key, gap, noise)

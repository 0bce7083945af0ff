"""K2: the port's shade_fused against the JAX package's shade_fused, run in
interpret mode as tests/test_shade_kernel.py runs it; and the arithmetic of
the CUDA kernels (one online pass per point over the live columns, the
backward without its wsum pass, the packed table), modelled in plain
PyTorch (torch_parity.shade_online, shade_backward_model), against the
plain version and the JAX kernel.

On the CPU the port's wrapper runs its plain version (the render_diff tail
under autograd). Forward: rtol 1e-5, atol 1e-6. Gradients of all five
parameter groups (through the activations, from identical raw params):
rtol 2e-4, atol 1e-6. Padded slots get exactly 0; t and normal get no
gradient. The CUDA kernels are held against the plain version by the
cuda-marked tests (``pytest -m cuda tests/`` on a GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (cuda_device is a fixture)
    cuda_device,
    jax_params,
    nn,
    pad_raw,
    random_raw_params,
    shade_backward_model,
    shade_online,
    tt,
)

from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.models.scene import activate as j_activate
from burn_raymarching_tpu.ops.march import march_xla
from burn_raymarching_tpu.ops.pallas.shade_kernel import (
    shade_fused as j_shade_fused,
)
from burn_raymarching_tpu.ops.sdf import scene_normal, scene_sdf
from burn_raymarching_tpu_torch.models.scene import (
    activate,
    params_from_numpy,
)
from burn_raymarching_tpu_torch.ops.cuda import shade_kernel as k2

GROUPS = ("centers", "colors", "radii", "light_dir", "ambient")
M, PAD, K = 6, 4, 24.0


@pytest.fixture(scope="module")
def setup():
    raw = random_raw_params(9, M)
    ro, rd = j_rays(16, 8, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    c, _, r, _, _ = j_activate(jax_params(raw))
    t = march_xla(ro, rd, c, r, K)
    pf = ro + rd * (t + scene_sdf(ro + rd * t, c, r, K))
    normal = scene_normal(pf, c, r, K)
    cot = np.random.default_rng(9).normal(0, 1, (ro.shape[0], 3))
    return (raw, np.asarray(ro), np.asarray(rd), np.asarray(t),
            np.asarray(normal), cot.astype(np.float32))


def _jax_loss(raw, ro, rd, t, normal, cot, mask=None):
    def f(p):
        c, col, r, ld, amb = j_activate(p)
        out = j_shade_fused(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t),
                            jnp.asarray(normal), c, r, col, ld, amb, K,
                            mask=None if mask is None else jnp.asarray(mask),
                            tile_n=64, interpret=True)
        return jnp.sum(out * cot), out
    (_, out), g = jax.value_and_grad(f, has_aux=True)(jax_params(raw))
    return np.asarray(out), {k: np.asarray(getattr(g, k)) for k in GROUPS}


def _torch_loss(raw, ro, rd, t, normal, cot, mask=None, device="cpu"):
    p = params_from_numpy(raw, device=device)
    c, col, r, ld, amb = activate(p)
    out = k2.shade_fused(tt(ro).to(device), tt(rd).to(device),
                         tt(t).to(device), tt(normal).to(device), c, r, col,
                         ld, amb, K,
                         mask=None if mask is None else tt(mask).to(device))
    (out * tt(cot).to(device)).sum().backward()
    return nn(out), {k: nn(getattr(p, k).grad) for k in GROUPS}


def test_forward_and_gradients_match_jax_kernel(setup):
    raw, ro, rd, t, normal, cot = setup
    out_j, g_j = _jax_loss(raw, ro, rd, t, normal, cot)
    out_t, g_t = _torch_loss(raw, ro, rd, t, normal, cot)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)
    for name in GROUPS:
        np.testing.assert_allclose(g_t[name], g_j[name], rtol=2e-4,
                                   atol=1e-6, err_msg=name)


def test_masked_padding_matches_and_padded_grads_are_zero(setup):
    raw, ro, rd, t, normal, cot = setup
    padded = pad_raw(raw, PAD)
    mask = np.arange(M + PAD) < M
    out_j, g_j = _jax_loss(padded, ro, rd, t, normal, cot, mask=mask)
    out_t, g_t = _torch_loss(padded, ro, rd, t, normal, cot, mask=mask)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)
    for name in GROUPS:
        np.testing.assert_allclose(g_t[name], g_j[name], rtol=2e-4,
                                   atol=1e-6, err_msg=name)
    for name in ("centers", "colors", "radii"):
        np.testing.assert_array_equal(g_t[name][M:], 0.0)


def test_no_gradient_reaches_t_or_normal(setup):
    raw, ro, rd, t, normal, cot = setup
    p = params_from_numpy(raw, device="cpu")
    c, col, r, ld, amb = activate(p)
    t_in = tt(t).requires_grad_(True)
    n_in = tt(normal).requires_grad_(True)
    out = k2.shade_fused(tt(ro), tt(rd), t_in, n_in, c, r, col, ld, amb, K)
    (out * tt(cot)).sum().backward()
    assert t_in.grad is None and n_in.grad is None
    assert p.centers.grad is not None


# --- The CUDA kernels' arithmetic, modelled on the CPU ------------------ #

def _scene(kind: str, m: int, live, seed: int = 3):
    """Raw params with ``m`` slots, a mask and rays for one online-pass
    case. ``live``: a count (the leading slots) or a mask. Kinds: "random"
    (the module's camera); "far" (rays that miss, t at the march's cap, so
    every exp but the minimum's underflows); "ascending" / "descending"
    (spheres lined up behind one another: the running minimum never moves
    after the first column / moves at every column)."""
    rng = np.random.default_rng(seed)
    raw = random_raw_params(seed, m)
    mask = (np.arange(m) < live) if np.isscalar(live) else np.asarray(live)
    ro, rd = (np.asarray(x) for x in
              j_rays(8, 8, [0.0, 0.5, -2.5], [0, 0, 0], 50.0))
    t = rng.uniform(1.5, 3.0, (ro.shape[0], 1)).astype(np.float32)
    if kind == "far":
        t = np.full_like(t, 1e4)
    elif kind in ("ascending", "descending"):
        z = 0.5 + 0.3 * np.arange(m, dtype=np.float32)
        raw["centers"] = np.stack([np.zeros(m), np.zeros(m),
                                   z if kind == "ascending" else z[::-1]],
                                  axis=1).astype(np.float32)
        raw["radii"] = np.full((m, 1), -2.0, np.float32)
    normal = rng.normal(0, 0.2, (ro.shape[0], 3)).astype(np.float32)
    return raw, mask, ro, rd, t, normal


ONLINE_CASES = [
    ("random", 1, 1, 1), ("random", 8, 8, 4), ("random", 8, 1, 4),
    ("random", 16, 10, 2), ("random", 16, 10, 8), ("random", 128, 100, 8),
    ("random", 128, 100, 32),
    ("random", 16, [1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0], 4),
    ("far", 16, 10, 4), ("far", 128, 100, 8),
    ("ascending", 16, 16, 1), ("descending", 16, 16, 1),
    ("ascending", 16, 16, 4), ("descending", 128, 128, 8),
]


@pytest.mark.parametrize("kind,m,live,lanes", ONLINE_CASES)
def test_online_pass_matches_plain_and_jax_kernel(kind, m, live, lanes):
    """Forward, atol 1e-5 (rgb lies in [0, 1]): the running minimum and the
    rescaled sums round differently from the two-pass softmax."""
    raw, mask, ro, rd, t, normal = _scene(kind, m, live)
    c, col, r, ld, amb = activate(params_from_numpy(raw, device="cpu"))
    with torch.no_grad():
        table = k2.shade_table(c, r, col, tt(mask), ld, amb)
        assert int(table[-1, 1]) == int(np.flatnonzero(mask).max()) + 1
        got = shade_online(tt(ro), tt(rd), tt(t), tt(normal), table, K,
                           lanes=lanes)
        plain = k2.shade_plain(tt(ro), tt(rd), tt(t), tt(normal), c, r, col,
                               ld, amb, K, mask=tt(mask))
    jc, jcol, jr, jld, jamb = j_activate(jax_params(raw))
    want = j_shade_fused(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t),
                         jnp.asarray(normal), jc, jr, jcol, jld, jamb, K,
                         mask=jnp.asarray(mask), tile_n=64, interpret=True)
    np.testing.assert_allclose(nn(got), nn(plain), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nn(got), np.asarray(want), rtol=0, atol=1e-5)
    if kind == "far":
        # Every other exp underflows: the sums hold the minimum's 1 alone
        # and nothing is NaN.
        assert np.isfinite(nn(got)).all()


@pytest.mark.parametrize("kind,m,live", [("random", 8, 8), ("random", 16, 10),
                                         ("random", 128, 100), ("far", 16, 10),
                                         ("descending", 16, 12)])
def test_backward_model_matches_autograd_float64(kind, m, live):
    """wsum = dmix·mix (no pass over the columns) and the folded l̂ → light
    projection, in float64 against autograd of the plain tail: 1e-10 of
    each group's largest gradient."""
    raw, mask, ro, rd, t, normal = _scene(kind, m, live)
    f64 = lambda x: tt(x).double()  # noqa: E731
    cot = f64(np.random.default_rng(5).normal(0, 1, (ro.shape[0], 3)))
    leaves = [x.detach().double().requires_grad_()
              for x in activate(params_from_numpy(raw, device="cpu"))]
    c, col, r, ld, amb = leaves
    out = k2.shade_plain(f64(ro), f64(rd), f64(t), f64(normal), c, r, col,
                         ld, amb, K, mask=tt(mask))
    want = torch.autograd.grad(out, [c, r, col, ld, amb], cot)
    with torch.no_grad():
        table = k2.shade_table(c, r, col, tt(mask), ld, amb).double()
        # shade_table packs float32; rebuild the float64 rows it rounded.
        table[:m, :3], table[m:2 * m, 0:1], table[m:2 * m, 1:] = c, r, col
        table[:m, 3] = torch.where(tt(mask), (c * c).sum(1), 1e30)
        l_norm = torch.sqrt((ld * ld).sum())
        table[2 * m, :3], table[2 * m, 3] = ld / l_norm, amb[0]
        table[2 * m + 1, 0] = l_norm
        got = shade_backward_model(f64(ro), f64(rd), f64(t), f64(normal),
                                   table, K, cot)
    for name, a, b in zip(("centers", "radii", "colors", "light", "ambient"),
                          got, want):
        scale = max(b.abs().max().item(), 1e-30)
        assert (a.reshape(b.shape) - b).abs().max().item() <= 1e-10 * scale, \
            name
    for a in got[:3]:
        assert (a[live:] == 0).all()


def test_pack_table_matches_jax_kernel_inputs(monkeypatch):
    """The pack's plain version against the table the JAX wrapper hands its
    kernel (prim, c_sq, scal), with a mask: the same numbers in another
    layout; |c|² to 1e-6 relative (another summation order)."""
    from burn_raymarching_tpu.ops.pallas import shade_kernel as jk

    m = 12
    raw = random_raw_params(21, m)
    mask = np.asarray([1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 0, 0], bool)
    seen = {}

    def capture(ro, rd, t, normal, prim, c_sq, scal, tile, interpret):
        seen.update(prim=np.asarray(prim), c_sq=np.asarray(c_sq),
                    scal=np.asarray(scal))
        return jnp.zeros((ro.shape[0], 3), jnp.float32)

    monkeypatch.setattr(jk, "_shade_call", capture)
    jc, jcol, jr, jld, jamb = j_activate(jax_params(raw))
    rays = jnp.zeros((8, 3), jnp.float32)
    jk.shade_fused(rays, rays, jnp.zeros((8, 1)), rays, jc, jr, jcol, jld,
                   jamb, K, mask=jnp.asarray(mask), interpret=True)
    c, col, r, ld, amb = activate(params_from_numpy(raw, device="cpu"))
    table = nn(k2.shade_table(c, r, col, tt(mask), ld, amb))
    assert table.shape == (2 * m + 2, 4)
    prim, c_sq, scal = seen["prim"][:, :m], seen["c_sq"][0, :m], seen["scal"][0]
    np.testing.assert_allclose(table[:m, :3], prim[0:3].T, rtol=1e-6)
    np.testing.assert_allclose(table[m:2 * m, 0], prim[3], rtol=1e-6)
    np.testing.assert_allclose(table[m:2 * m, 1:], prim[4:7].T, rtol=1e-6)
    np.testing.assert_allclose(table[:m, 3], c_sq, rtol=1e-6)
    assert (table[:m, 3][~mask] == np.float32(1e30)).all()
    light = scal[1:4]
    np.testing.assert_allclose(table[2 * m, :3],
                               light / np.linalg.norm(light), rtol=1e-6)
    np.testing.assert_allclose(table[2 * m, 3], scal[4], rtol=1e-6)
    np.testing.assert_allclose(table[2 * m + 1, 0], np.linalg.norm(light),
                               rtol=1e-6)
    assert table[2 * m + 1, 1] == 9.0     # last live slot is index 8
    assert (table[2 * m + 1, 2:] == 0).all()


def test_table_visits_all_columns_without_a_mask_or_a_live_slot():
    raw = random_raw_params(2, 5)
    c, col, r, ld, amb = activate(params_from_numpy(raw, device="cpu"))
    for mask in (None, torch.zeros(5, dtype=torch.bool)):
        assert k2.shade_table(c, r, col, mask, ld, amb)[-1, 1] == 5.0


@pytest.mark.parametrize("rows,nodes", [(1, 1), (2, 1), (16, 1), (17, 3),
                                        (132, 10), (264, 20), (800, 55)])
def test_sum_tree_node_count(rows, nodes):
    """The wrappers size the sum tree's scratch rows and tickets from the
    fan-in that csrc/common.cuh compiles in."""
    import os
    import re

    from burn_raymarching_tpu_torch.ops.cuda import build

    with open(os.path.join(build.CSRC_DIR, "common.cuh")) as f:
        fan = int(re.search(r"#define SUM_TREE_FAN (\d+)", f.read()).group(1))
    assert build.SUM_TREE_FAN == fan
    assert build.tree_nodes(rows) == nodes
    # Level by level: every node takes up to ``fan`` rows of the level below.
    level, total = rows, 0
    while level > 1 or total == 0:
        level = -(-level // fan)
        total += level
    assert total == nodes


@pytest.mark.cuda
def test_cuda_kernels_match_plain(setup, cuda_device):
    raw, ro, rd, t, normal, cot = setup
    padded = pad_raw(raw, PAD)
    mask = np.arange(M + PAD) < M
    counters = (k2.pack_shade_table, k2.launch_shade_fwd, k2.launch_shade_bwd)
    before = [fn.launches for fn in counters]
    out_k, g_k = _torch_loss(padded, ro, rd, t, normal, cot, mask=mask,
                             device=cuda_device)
    # One launch each: the pack, the forward, the backward with its sums.
    assert [fn.launches for fn in counters] == [b + 1 for b in before]
    out_p, g_p = _torch_loss(padded, ro, rd, t, normal, cot, mask=mask)
    np.testing.assert_allclose(out_k, out_p, rtol=1e-5, atol=1e-6)
    for name in GROUPS:
        np.testing.assert_allclose(g_k[name], g_p[name], rtol=2e-4,
                                   atol=1e-6, err_msg=name)
        if name in ("centers", "colors", "radii"):
            np.testing.assert_array_equal(g_k[name][M:], 0.0)
    # Fixed-order partial sums: bitwise repeatable.
    _, g_k2 = _torch_loss(padded, ro, rd, t, normal, cot, mask=mask,
                          device=cuda_device)
    for name in GROUPS:
        np.testing.assert_array_equal(g_k2[name], g_k[name])


@pytest.mark.cuda
def test_cuda_wrapper_validates_inputs(setup, cuda_device):
    raw, ro, rd, t, normal, _ = setup
    p = params_from_numpy(raw, device=cuda_device)
    c, col, r, ld, amb = activate(p)
    bad_t = tt(t).to(cuda_device).double()
    with pytest.raises(ValueError):
        k2.shade_fused(tt(ro).to(cuda_device), tt(rd).to(cuda_device), bad_t,
                       tt(normal).to(cuda_device), c, r, col, ld, amb, K)
    assert torch.cuda.is_available()


@pytest.mark.cuda
def test_cuda_kernels_large_table(cuda_device):
    """M = 1,500 slots: the backward's accumulators need more than 48 KB of
    shared memory (the opt-in attribute path)."""
    rng = np.random.default_rng(14)
    m, live = 1500, 1200
    raw = random_raw_params(14, m)
    raw["centers"] = (rng.normal(0, 0.4, (m, 3))).astype(np.float32)
    raw["radii"] = np.full((m, 1), -3.0, np.float32)
    mask = np.arange(m) < live
    ro, rd = (np.asarray(x) for x in
              j_rays(16, 16, [0.0, 0.3, -1.5], [0, 0, 0], 50.0))
    p = params_from_numpy(raw, device="cpu")
    c, _, r, _, _ = activate(p)
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade_plain,
    )
    t, normal = march_shade_plain(tt(ro), tt(rd), c.detach(), r.detach(), K,
                                  mask=tt(mask))
    cot = rng.normal(0, 1, (ro.shape[0], 3)).astype(np.float32)
    out_k, g_k = _torch_loss(raw, ro, rd, nn(t), nn(normal), cot, mask=mask,
                             device=cuda_device)
    out_p, g_p = _torch_loss(raw, ro, rd, nn(t), nn(normal), cot, mask=mask)
    # 1,200-term exp sums in another order: 3.5e-5 relative seen on an H100.
    np.testing.assert_allclose(out_k, out_p, rtol=1e-4, atol=1e-5)
    for name in GROUPS:
        tol = 1e-3 * np.abs(g_p[name]).max() + 1e-6
        np.testing.assert_allclose(g_k[name], g_p[name], rtol=0, atol=tol,
                                   err_msg=name)
    for name in ("centers", "colors", "radii"):
        np.testing.assert_array_equal(g_k[name][live:], 0.0)


def _cuda_case(kind, m, live, dev):
    raw, mask, ro, rd, t, normal = _scene(kind, m, live)
    c, col, r, ld, amb = (
        x.detach().to(dev)
        for x in activate(params_from_numpy(raw, device="cpu")))
    rays = tuple(tt(x).to(dev) for x in (ro, rd, t, normal))
    return rays, (c, r, col, ld, amb), tt(mask).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,live", [(12, 9), (128, 100), (1, 1), (16, 1)])
def test_cuda_pack_is_bitwise_the_plain_table(cuda_device, m, live):
    _, (c, r, col, ld, amb), mask = _cuda_case("random", m, live, cuda_device)
    for msk in (mask, None):
        got = k2.pack_shade_table(c, r, col, msk, ld, amb)
        want = k2.shade_table(c, r, col, msk, ld, amb)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, 1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("kind,m,live", [("random", 13, 13),
                                         ("random", 16, 1),
                                         ("far", 16, 10),
                                         ("descending", 40, 37)])
def test_cuda_launches_match_plain_for_every_lane_count(cuda_device, lanes,
                                                        kind, m, live):
    """64 rays (not a multiple of a block's rays for most lane counts), M
    not a multiple of the lane group, one live slot, far rays: forward 1e-5,
    gradients 1e-3 of each group's largest entry, padded slots exactly 0,
    two runs bitwise equal, and the launch's own sum equal to the sum of
    its partial rows."""
    rays, params, mask = _cuda_case(kind, m, live, cuda_device)
    rays = tuple(x[:61].contiguous() for x in rays)
    cot = torch.as_tensor(np.random.default_rng(8).normal(0, 1, (61, 3)),
                          dtype=torch.float32, device=cuda_device)
    table = k2.pack_shade_table(params[0], params[1], params[2], mask,
                                params[3], params[4])
    out = k2.launch_shade_fwd(*rays, table, K, lanes=lanes)
    leaves = [x.clone().requires_grad_() for x in params]
    out_p = k2.shade_plain(*rays, *leaves, K, mask=mask)
    want = torch.autograd.grad(out_p, leaves, cot)
    np.testing.assert_allclose(nn(out), nn(out_p), rtol=0, atol=1e-5)
    first = k2.launch_shade_bwd(*rays, table, K, cot, lanes=lanes)
    second = k2.launch_shade_bwd(*rays, table, K, cot, lanes=lanes)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    *got, partial = first
    for name, a, b in zip(GROUPS_KERNEL, got, want):
        tol = 1e-3 * b.abs().max().item() + 1e-6
        assert (a.reshape(b.shape) - b).abs().max().item() <= tol, name
    for a in got[:3]:
        assert (a[live:] == 0).all()
    total = partial.sum(0)
    np.testing.assert_allclose(nn(got[1]), nn(total[3 * m:4 * m]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(nn(got[4]), nn(total[7 * m + 3:]), rtol=1e-5,
                               atol=1e-6)


GROUPS_KERNEL = ("centers", "radii", "colors", "light", "ambient")


@pytest.mark.cuda
def test_cuda_main_path_shape(cuda_device):
    """16,384 rays against 100 live of 128 slots, through the public
    wrapper: the partial rows stay under 300 and two runs agree bitwise."""
    rng = np.random.default_rng(4)
    (ro, rd, t, normal), params, mask = _cuda_case("random", 128, 100,
                                                   cuda_device)
    pick = torch.as_tensor(rng.integers(0, ro.shape[0], 16384),
                           device=cuda_device)
    rays = tuple(x[pick].contiguous() for x in (ro, rd, t, normal))
    cot = torch.as_tensor(rng.normal(0, 1, (16384, 3)), dtype=torch.float32,
                          device=cuda_device)

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in params]
        out = fn(*rays, *leaves, K, mask=mask)
        return out.detach(), torch.autograd.grad(out, leaves, cot)

    out_k, g_k = grads(k2.shade_fused)
    out_p, g_p = grads(k2.shade_plain)
    np.testing.assert_allclose(nn(out_k), nn(out_p), rtol=0, atol=1e-5)
    for name, a, b in zip(GROUPS_KERNEL, g_k, g_p):
        tol = 1e-3 * b.abs().max().item() + 1e-6
        assert (a - b).abs().max().item() <= tol, name
    for a, b in zip(g_k, grads(k2.shade_fused)[1]):
        assert torch.equal(a, b)
    table = k2.pack_shade_table(params[0], params[1], params[2], mask,
                                params[3], params[4])
    assert k2.launch_shade_bwd(*rays, table, K, cot)[-1].shape[0] <= 300


@pytest.mark.cuda
def test_cuda_backward_rejects_too_many_slots(cuda_device):
    m = 9000
    z = torch.zeros((m, 3), device=cuda_device)
    table = k2.pack_shade_table(z, torch.ones((m, 1), device=cuda_device), z,
                                None, torch.ones(3, device=cuda_device),
                                torch.ones(1, device=cuda_device))
    rays = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        k2.launch_shade_bwd(rays, rays, rays[:, :1].contiguous(), rays, table,
                            K, rays)

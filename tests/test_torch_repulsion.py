"""Two-level cluster repulsion + K4: the port's cluster_repulsion, its frozen
static prep and the K4 wrapper against the JAX package's, on the same numpy
clouds.

Values: rtol 1e-5; gradients: rtol 1e-4 with atol 1e-5 of the largest
entry (float32 sums over thousands of pairs in another order). Static vs
live prep at equal centers: exact, as tests/test_repulsion_kernel.py:146
requires of the JAX package. On the CPU the K4 wrapper runs its plain
version; the cuda-marked tests hold the CUDA kernel against it on a GPU.
The kernels cut each cluster's columns into slices, one block each, and add
the slices in slice order: torch_parity.repulsion_sum_sliced models that in
plain PyTorch and is held against the plain sum and the JAX package here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (cuda_device is a fixture)
    cuda_device,
    jax_params,
    nn,
    random_raw_params,
    repulsion_sum_sliced,
    tt,
)

from burn_raymarching_tpu.ops.culling import build_clusters as j_clusters
from burn_raymarching_tpu.ops.pallas.repulsion_kernel import (
    cluster_repulsion_fused as j_fused,
)
from burn_raymarching_tpu.train import loss as jl
from burn_raymarching_tpu_torch.models.scene import params_from_numpy
from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4
from burn_raymarching_tpu_torch.ops.culling import build_clusters
from burn_raymarching_tpu_torch.train import loss as tl


def make_cloud(m, seed, group=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.8, 0.8, (m, 3)).astype(np.float32)
    mask = rng.random(m) > 0.1
    return centers, mask, group


def _jax(centers, mask, group, far_field, static):
    cl = j_clusters(centers, mask=mask, group=group)
    jm = jnp.asarray(mask)
    n_valid = jnp.sum(jm.astype(jnp.float32))
    st = jl.build_repulsion_static(jnp.asarray(centers), cl, jm) if static \
        else None
    v, g = jax.value_and_grad(lambda c: jl.cluster_repulsion(
        c, cl, jm, n_valid, far_field=far_field, static=st))(
            jnp.asarray(centers))
    return float(v), np.asarray(g)


def _torch(fn, centers, mask, group, far_field, static, dev="cpu"):
    cl = build_clusters(centers, mask=mask, group=group, device=dev)
    tm = tt(mask).to(dev)
    c = tt(centers).to(dev).requires_grad_()
    st = tl.build_repulsion_static(c, cl, tm) if static else None
    v = fn(c, cl, tm, tm.float().sum(), far_field=far_field, static=st)
    (g,) = torch.autograd.grad(v, [c])
    return v.item(), nn(g)


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4,
                               atol=1e-5 * np.abs(want[1]).max())


CASES = [(200, 8, "member", False), (200, 8, "monopole", False),
         (200, 8, "member", True), (200, 8, "monopole", True),
         (96, 4, "member", False)]


@pytest.mark.parametrize("m,group,far_field,static", CASES)
def test_cluster_repulsion_matches_jax(m, group, far_field, static):
    centers, mask, group = make_cloud(m, seed=m + group, group=group)
    _close(_torch(tl.cluster_repulsion, centers, mask, group, far_field,
                  static),
           _jax(centers, mask, group, far_field, static))


@pytest.mark.parametrize("m,group,far_field,static", CASES)
def test_fused_wrapper_matches_jax(m, group, far_field, static):
    """The K4 wrapper (plain planes sum on the CPU) and JAX's own fused
    kernel in interpret mode agree with JAX's cluster_repulsion."""
    centers, mask, group = make_cloud(m, seed=m + group, group=group)
    want = _jax(centers, mask, group, far_field, static)
    _close(_torch(k4.cluster_repulsion_fused, centers, mask, group,
                  far_field, static), want)
    cl = j_clusters(centers, mask=mask, group=group)
    jm = jnp.asarray(mask)
    st = jl.build_repulsion_static(jnp.asarray(centers), cl, jm) if static \
        else None
    fused = functools.partial(j_fused, interpret=True)
    v = fused(jnp.asarray(centers), cl, jm, jnp.sum(jm.astype(jnp.float32)),
              far_field=far_field, static=st)
    np.testing.assert_allclose(float(v), want[0], rtol=1e-5)


@pytest.mark.parametrize("fn", [tl.cluster_repulsion,
                                k4.cluster_repulsion_fused])
@pytest.mark.parametrize("far_field", ["member", "monopole"])
def test_static_prep_equals_live_prep_exactly(fn, far_field):
    centers, mask, group = make_cloud(200, seed=7)
    v0, g0 = _torch(fn, centers, mask, group, far_field, static=False)
    v1, g1 = _torch(fn, centers, mask, group, far_field, static=True)
    assert v1 == v0
    np.testing.assert_array_equal(g1, g0)


def test_static_tables_match_jax():
    centers, mask, group = make_cloud(200, seed=5)
    st_j = jl.build_repulsion_static(
        jnp.asarray(centers), j_clusters(centers, mask=mask, group=group),
        jnp.asarray(mask))
    st_t = tl.build_repulsion_static(
        tt(centers),
        build_clusters(centers, mask=mask, group=group, device="cpu"),
        tt(mask))
    for name in st_j._fields:
        np.testing.assert_array_equal(nn(getattr(st_t, name)),
                                      np.asarray(getattr(st_j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("far_field", ["member", "monopole"])
def test_compute_loss_routes_cluster_repulsion_like_jax(far_field):
    """compute_loss with repulsion_clusters (plain and K4 wrapper) equals
    the JAX package's, value and gradient of every parameter."""
    from burn_raymarching_tpu.config import LossConfig

    m = 64
    raw = random_raw_params(11, m)
    raw["centers"] = raw["centers"] * 2.0
    mask = np.arange(m) < 58
    rng = np.random.default_rng(2)
    out = rng.random((256, 3)).astype(np.float32)
    tgt = np.roll(out, 1, axis=0)
    cfg = LossConfig(repulsion_far_field=far_field)
    cl_j = j_clusters(raw["centers"], mask=mask, group=8)
    l_j, g_j = jax.value_and_grad(lambda p: jl.compute_loss(
        p, jnp.asarray(out), jnp.asarray(tgt), jnp.float32(0.3),
        mask=jnp.asarray(mask), cfg=cfg, repulsion_clusters=cl_j))(
            jax_params(raw))
    cl_t = build_clusters(raw["centers"], mask=mask, group=8, device="cpu")
    for fn in (None, k4.cluster_repulsion_fused):
        p = params_from_numpy(raw, device="cpu")
        loss = tl.compute_loss(p, tt(out), tt(tgt), 0.3, mask=tt(mask),
                               cfg=cfg, repulsion_clusters=cl_t,
                               repulsion_fn=fn)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-6)
        for name in ("centers", "radii"):
            want = np.asarray(getattr(g_j, name))
            np.testing.assert_allclose(nn(getattr(p, name).grad), want,
                                       rtol=1e-4,
                                       atol=1e-6 * np.abs(want).max())


# --- The kernels' slice decomposition, modelled on the CPU -------------- #

SLICE_CLOUDS = {
    # name: (primitives, group) -> clusters C, columns W·G (+ C_all)
    "C=25": (200, 8),
    "C=1": (6, 8),              # one cluster: C_all = 1, smaller than a slice
    "C=3": (20, 8),             # C_all = 3 centroids in a slice of >= 9
}


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("far_field", ["member", "monopole"])
@pytest.mark.parametrize("cloud", sorted(SLICE_CLOUDS))
def test_sliced_sum_matches_plain_and_jax(monkeypatch, cloud, far_field,
                                          slices):
    """Value 1e-6 relative, gradients 1e-5 of the largest entry: the same
    float32 terms, added slice by slice."""
    m, group = SLICE_CLOUDS[cloud]
    centers, mask, _ = make_cloud(m, seed=m)
    mask[:2] = True

    def sliced(*planes):
        return repulsion_sum_sliced(*planes, slices=slices)

    plain = _torch(k4.cluster_repulsion_fused, centers, mask, group,
                   far_field, static=True)
    monkeypatch.setattr(k4, "repulsion_sum", sliced)
    got = _torch(k4.cluster_repulsion_fused, centers, mask, group, far_field,
                 static=True)
    for want in (plain, _jax(centers, mask, group, far_field, True)):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=1e-5 * np.abs(want[1]).max())


# --- CUDA kernel against its plain version (GPU only) ------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("m,far_field", [(5120, "member"), (5120, "monopole"),
                                         (51200, "member")])
def test_cuda_kernel_matches_plain(cuda_device, m, far_field):
    centers, mask, _ = make_cloud(m, seed=1)
    want = _torch(tl.cluster_repulsion, centers, mask, 64, far_field,
                  static=True, dev=cuda_device)
    before = (k4.launch_rep_fwd.launches, k4.launch_rep_bwd.launches)
    got = _torch(k4.cluster_repulsion_fused, centers, mask, 64, far_field,
                 static=True, dev=cuda_device)
    torch.cuda.synchronize()
    assert (k4.launch_rep_fwd.launches, k4.launch_rep_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _close(got, want)


@pytest.mark.cuda
def test_cuda_kernel_gradients_are_bitwise_repeatable(cuda_device):
    centers, mask, _ = make_cloud(5120, seed=2)
    cl = build_clusters(centers, mask=mask, group=64, device=cuda_device)
    c = tt(centers).to(cuda_device)
    planes, *_ = k4.repulsion_planes(c, cl, tt(mask).to(cuda_device))
    g = torch.ones((1,), device=cuda_device)
    first = k4.launch_rep_bwd(*planes, g, True)
    second = k4.launch_rep_bwd(*planes, g, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(k4.launch_rep_fwd(*planes, True)[0],
                       k4.launch_rep_fwd(*planes, True)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [0, 1, 2, 3, 5, 8, 1000])
@pytest.mark.parametrize("m,group,include_far", [(450, 64, True),
                                                 (450, 64, False),
                                                 (100, 12, True),
                                                 (40, 64, True)])
def test_cuda_launches_match_plain_for_every_slice_count(cuda_device, m,
                                                         group, include_far,
                                                         slices):
    """C = 8 (not a multiple of most slice counts), G = 12 (rows padded to
    16 inside the kernel) and C = 1 against autograd of the plain sum;
    the launches' own sums against the sums of their parts; two runs
    bitwise equal. 1000 slices: clipped to one column each."""
    centers, mask, _ = make_cloud(m, seed=m)
    cl = build_clusters(centers, mask=mask, group=group, device=cuda_device)
    planes, *_ = k4.repulsion_planes(tt(centers).to(cuda_device), cl,
                                     tt(mask).to(cuda_device))
    leaves = [x.clone().requires_grad_() for x in planes[:3]]
    s_p = k4.repulsion_sum_plain(*leaves, *planes[3:], include_far)
    want = torch.autograd.grad(s_p, leaves, allow_unused=True)
    s_k, partial = k4.launch_rep_fwd(*planes, include_far, slices=slices)
    np.testing.assert_allclose(s_k.item(), s_p.item(), rtol=1e-5)
    np.testing.assert_allclose(s_k.item(), partial.sum().item(), rtol=1e-6)
    g = torch.ones((1,), device=cuda_device)
    first = k4.launch_rep_bwd(*planes, g, include_far, slices=slices)
    second = k4.launch_rep_bwd(*planes, g, include_far, slices=slices)
    scale = max(w.abs().max().item() for w in want if w is not None)
    for a, b, w in zip(first, second, want):
        assert (a is None) == (w is None)
        if a is not None:
            assert torch.equal(a, b)
            assert (a - w).abs().max().item() <= 1e-5 * scale
    if include_far:
        np.testing.assert_allclose(nn(first[2]), nn(first[3].sum(0)),
                                   rtol=1e-5, atol=1e-6 * scale)

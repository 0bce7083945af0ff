"""render/culled + K3: the port's culled march, its K3 wrapper and the culled
differentiable renderer against the JAX package's, on the same inputs.

On the CPU the K3 wrapper runs its plain version (culled_march_normals_xla),
so both are held against JAX's culled_march_normals_xla and against the
Pallas kernel in interpret mode (as tests/test_culled_kernel.py runs it).
t on rays that hit (t < 10): rtol/atol 1e-5; on all rays |dt|/(1+t) <=
5e-4 — a ray that grazes a sphere converges slowly, and 40 steps amplify
float32 rounding there (1.4e-4 seen at t = 13). Normals on rays that hit:
atol 2e-3. They are differences of two soft-mins 2e-4 apart, each carrying
the expanded form's cancellation error, ~ulp(|p|^2) = 2.4e-7, which the
1/(2 eps) difference turns into ~1e-3 (1.3e-3 seen): XLA's dot and
torch.bmm round differently. Renders: rtol 1e-4 with atol 5e-4, as
tests/test_torch_render.py holds render_tiled (the normals' noise moves the
shading of grazing pixels); gradients: rtol 1e-3 with atol 2e-3 of the
largest entry — near-miss rays keep coverage sigmoid(-60 d) ~ 1e-3 while
their normals are rounding-noise directions (1.2e-3 of the largest color
gradient seen). The cuda-marked tests hold the CUDA
kernel against the plain version on a GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (cuda_device is a fixture)
    cuda_device,
    expanded_q,
    nn,
    soft_min_online,
    staged_q,
    tt,
)

from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.ops import culling as jc
from burn_raymarching_tpu.ops.pallas.culled_march_kernel import (
    culled_march_normals_pallas,
)
from burn_raymarching_tpu.render import culled as jr
from burn_raymarching_tpu.render.preview import CullRender as JCullRender
from burn_raymarching_tpu.render.preview import render_tiled as j_tiled
from burn_raymarching_tpu.models.scene import SceneParams as JParams
from burn_raymarching_tpu.utils.morton import morton_permutation
from burn_raymarching_tpu_torch.models.scene import SceneParams
from burn_raymarching_tpu_torch.ops import culling as tc
from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
from burn_raymarching_tpu_torch.ops.sdf import soft_min
from burn_raymarching_tpu_torch.render import culled as tr
from burn_raymarching_tpu_torch.render.preview import CullRender, render_tiled
from burn_raymarching_tpu_torch.tools import kernel_cases as kc

TILE = 64
BUDGET = 8
SMOOTH_K = 18.5


@pytest.fixture(scope="module")
def scene():
    """A Morton-ordered 16x16 view (4 tiles of 64) and 12 primitives, the
    last two masked out."""
    ro, rd = j_rays(16, 16, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0], 50.0)
    perm = morton_permutation(16, 16)
    rng = np.random.default_rng(7)
    m = 12
    return dict(
        ro=np.asarray(ro)[perm], rd=np.asarray(rd)[perm],
        centers=rng.normal(0, 0.35, (m, 3)).astype(np.float32),
        radii=(0.05 + 0.15 * rng.random((m, 1))).astype(np.float32),
        colors=rng.random((m, 3)).astype(np.float32),
        light=np.asarray([0.3, 1.0, -0.4], np.float32),
        ambient=np.asarray([0.2], np.float32),
        mask=np.arange(m) < 10)


def _tables(s):
    """JAX selection + gathered tables, as numpy."""
    cones = jc.tile_cones(jnp.asarray(s["ro"]), jnp.asarray(s["rd"]), TILE)
    idx, valid = jc.select_tile_primitives(
        cones, jnp.asarray(s["centers"]), jnp.asarray(s["radii"]), SMOOTH_K,
        BUDGET, mask=jnp.asarray(s["mask"]))
    cs, _, rs, qs = jc.gather_tile_tables(
        jnp.asarray(s["centers"]), jnp.asarray(s["colors"]),
        jnp.asarray(s["radii"]), idx, valid)
    b = s["ro"].shape[0] // TILE
    return (s["ro"].reshape(b, TILE, 3), s["rd"].reshape(b, TILE, 3),
            np.asarray(cs), np.asarray(rs), np.asarray(qs))


def _check(got, want, normal_atol=2e-3):
    (t_g, n_g), (t_w, n_w) = got, want
    t_g, t_w, n_w = nn(t_g), np.asarray(t_w), np.asarray(n_w)
    hit = t_w[..., 0] < 10.0
    assert hit.sum() > 20
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=1e-5, atol=1e-5)
    assert (np.abs(t_g - t_w) / (1.0 + np.abs(t_w))).max() <= 5e-4
    np.testing.assert_allclose(nn(n_g)[hit], n_w[hit], atol=normal_atol)


@pytest.mark.parametrize("fn", [tr.culled_march_normals_xla,
                                k3.culled_march_normals])
def test_cold_march_matches_jax(scene, fn):
    ro3, rd3, cs, rs, qs = _tables(scene)
    want = jr.culled_march_normals_xla(*(jnp.asarray(x) for x in
                                         (ro3, rd3, cs, rs, qs)), SMOOTH_K)
    got = fn(tt(ro3), tt(rd3), tt(cs), tt(rs), tt(qs), SMOOTH_K)
    _check(got, want)


def test_warm_march_matches_jax_kernel(scene):
    """16 steps from 0.8 t_cold, against the Pallas kernel (interpret)."""
    ro3, rd3, cs, rs, qs = _tables(scene)
    kern = functools.partial(culled_march_normals_pallas, interpret=True,
                             tile_t=TILE)
    args = [jnp.asarray(x) for x in (ro3, rd3, cs, rs, qs)]
    t_cold, _ = kern(*args, SMOOTH_K)
    t0 = (0.8 * np.asarray(t_cold)).astype(np.float32)
    want = kern(*args, SMOOTH_K, num_steps=16, t_init=jnp.asarray(t0))
    got = k3.culled_march_normals(tt(ro3), tt(rd3), tt(cs), tt(rs), tt(qs),
                                  SMOOTH_K, num_steps=16, t_init=tt(t0))
    _check(got, want)


def test_culled_table_unpacks(scene):
    """[B, K, 5] rows (cx, cy, cz, |c|^2, r): unpacking gives back the
    gathered tables, and invalid slots carry 1e30."""
    _, _, cs, rs, qs = _tables(scene)
    qs = qs.copy()
    qs[:, -2:] = 1e30           # the selection filled every slot: drop two
    table = k3.culled_table(tt(cs), tt(rs), tt(qs))
    assert table.shape == cs.shape[:2] + (5,) and table.is_contiguous()
    np.testing.assert_array_equal(nn(table[..., :3]), cs)
    np.testing.assert_array_equal(nn(table[..., 3]), qs)
    np.testing.assert_array_equal(nn(table[..., 4]), rs)
    invalid = qs > 1e29
    assert invalid.any() and not invalid.all()
    np.testing.assert_array_equal(qs[invalid], np.float32(1e30))
    valid_sq = np.sum(cs * cs, axis=2)[~invalid]
    np.testing.assert_allclose(nn(table[..., 3])[~invalid], valid_sq,
                               rtol=1e-6)


def test_staged_q_bitwise_equals_expanded(scene):
    """Per tile, the staged form (center scaled by -2) gives bitwise the
    expanded form's q in float32, invalid slots included."""
    ro3, rd3, cs, rs, qs = _tables(scene)
    table = k3.culled_table(tt(cs), tt(rs), tt(qs))
    rng = np.random.default_rng(3)
    t = tt(rng.uniform(0.0, 4.0, ro3.shape[:2] + (1,)).astype(np.float32))
    p = tt(ro3) + tt(rd3) * t
    got, want = staged_q(p, table), expanded_q(p, table)
    assert got.shape == ro3.shape[:2] + (BUDGET,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [1, 32])
def test_online_soft_min_matches_two_pass(scene, lanes):
    """The kernel's one-pass soft-min in K3's op order (distance, then
    *(-k)) against ops/sdf.soft_min on the same distances at k = 128, 1e-6
    relative, on points along the rays and one at distance ~50 (dropping
    the max would underflow it); and both against
    render/culled._tile_soft_min, whose bmm rounds the distances
    differently (a few ulp of |p|^2: atol 1e-6)."""
    ro3, rd3, cs, rs, qs = (tt(x) for x in _tables(scene))
    rng = np.random.default_rng(4)
    t = tt(rng.uniform(0.0, 4.0, tuple(ro3.shape[:2]) + (1,))
           .astype(np.float32))
    p = ro3 + rd3 * t
    p[0, 0] = torch.tensor([50.0, 0.0, 0.0])
    want = tr._tile_soft_min(p, cs, rs, qs, 128.0)
    table = k3.culled_table(cs, rs, qs)
    for b in range(p.shape[0]):
        dists = torch.sqrt(torch.clamp(staged_q(p[b], table[b]), min=1e-6)) \
            - table[b, :, 4]
        got = soft_min_online(dists, 128.0, lanes=lanes)
        np.testing.assert_allclose(nn(got), nn(soft_min(dists, 128.0)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(nn(got), nn(want[b]), rtol=1e-6,
                                   atol=1e-6)
    assert 48.0 < want[0, 0].item() < 50.0


def _render_args(s, lib):
    if lib == "jax":
        arr = jnp.asarray
        return ([arr(s[k]) for k in ("ro", "rd")],
                [arr(s[k]) for k in ("centers", "colors", "radii", "light",
                                     "ambient")], arr(s["mask"]))
    return ([tt(s[k]) for k in ("ro", "rd")],
            [tt(s[k]).requires_grad_() for k in ("centers", "colors", "radii",
                                                 "light", "ambient")],
            tt(s["mask"]))


def _jax_value_and_grads(s, cot, **kw):
    (ro, rd), params, mask = _render_args(s, "jax")

    def f(*p):
        out = jr.render_diff_culled(ro, rd, *p, SMOOTH_K, mask=mask,
                                    tile=TILE, k_budget=BUDGET,
                                    softmax_sharpness=40.0,
                                    mask_sharpness=60.0, **kw)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(5)),
                                         has_aux=True)(*params)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_value_and_grads(s, cot, **kw):
    (ro, rd), params, mask = _render_args(s, "torch")
    out = tr.render_diff_culled(ro, rd, *params, SMOOTH_K, mask=mask,
                                tile=TILE, k_budget=BUDGET,
                                softmax_sharpness=40.0, mask_sharpness=60.0,
                                **kw)
    grads = torch.autograd.grad(torch.sum(out * tt(cot)), params)
    return nn(out), [nn(g) for g in grads]


def _compare(got, want):
    (out_g, grads_g), (out_w, grads_w) = got, want
    np.testing.assert_allclose(out_g, out_w, rtol=1e-4, atol=5e-4)
    assert np.abs(out_w).max() > 0.05
    for name, g, w in zip(("centers", "colors", "radii", "light", "ambient"),
                          grads_g, grads_w):
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=2e-3 * np.abs(w).max() + 1e-9,
                                   err_msg=name)


@pytest.fixture(scope="module")
def cot(scene):
    rng = np.random.default_rng(1)
    return rng.normal(0, 1, scene["ro"].shape).astype(np.float32)


def test_render_diff_culled_self_selecting_matches_jax(scene, cot):
    _compare(_torch_value_and_grads(scene, cot),
             _jax_value_and_grads(scene, cot))


def test_render_diff_culled_with_kernel_wrapper_matches_jax(scene, cot):
    """march_normal_fn = the K3 wrapper (plain version on the CPU)."""
    _compare(_torch_value_and_grads(
        scene, cot, march_normal_fn=k3.culled_march_normals),
        _jax_value_and_grads(scene, cot))


def test_render_diff_culled_hierarchical_matches_jax(scene, cot):
    c, mask = scene["centers"], scene["mask"]
    _compare(_torch_value_and_grads(
        scene, cot,
        clusters=tc.build_clusters(c, mask=mask, group=4, device="cpu"),
        cluster_budget=2),
        _jax_value_and_grads(
            scene, cot, clusters=jc.build_clusters(c, mask=mask, group=4),
            cluster_budget=2))


def test_render_diff_culled_precomputed_matches_jax(scene, cot):
    """The training step's path: selection + march outside, tail only."""
    ro3, rd3, cs, rs, qs = _tables(scene)
    cones = jc.tile_cones(jnp.asarray(scene["ro"]), jnp.asarray(scene["rd"]),
                          TILE)
    idx, valid = jc.select_tile_primitives(
        cones, jnp.asarray(scene["centers"]), jnp.asarray(scene["radii"]),
        SMOOTH_K, BUDGET, mask=jnp.asarray(scene["mask"]))
    t0 = np.full(ro3.shape[:2] + (1,), 1.5, np.float32)
    t, normal = jr.culled_march_normals_xla(
        *(jnp.asarray(x) for x in (ro3, rd3, cs, rs, qs)), SMOOTH_K,
        num_steps=16, t_init=jnp.asarray(t0))
    pre_j = (idx, valid, t, normal)
    pre_t = (tt(idx).long(), tt(valid), tt(t), tt(normal))
    _compare(_torch_value_and_grads(scene, cot, precomputed=pre_t),
             _jax_value_and_grads(scene, cot, precomputed=pre_j))


def test_render_tiled_culled_morton_matches_jax(scene):
    s = scene
    ro, rd = j_rays(16, 16, [0.3, 0.4, -2.2], [0.0, 0.0, 0.0], 50.0)
    raw = {"centers": s["centers"], "colors": np.zeros_like(s["colors"]),
           "radii": np.log(np.expm1(s["radii"])), "light_dir": s["light"],
           "ambient": np.asarray([-1.4], np.float32)}
    kw = dict(smooth_k=SMOOTH_K, chunk=128, order_wh=(16, 16))
    want = j_tiled(JParams(**{k: jnp.asarray(v) for k, v in raw.items()}),
                   ro, rd, mask=jnp.asarray(s["mask"]),
                   cull=JCullRender(tile=TILE, k_budget=BUDGET), **kw)
    got = render_tiled(SceneParams(*(raw[k] for k in (
        "centers", "colors", "radii", "light_dir", "ambient"))),
        tt(ro), tt(rd), mask=tt(s["mask"]),
        cull=CullRender(tile=TILE, k_budget=BUDGET,
                        march_normal_fn=k3.culled_march_normals), **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=5e-4)


# --- CUDA kernel against its plain version (GPU only) ------------------- #

def _cuda_case(dev, b, t_dim, k_dim, seed):
    """Tile-coherent rays toward a random sphere cloud and random tables
    with ~10% invalid slots."""
    rng = np.random.default_rng(seed)
    ro, rd = j_rays(64, 64, [0.0, 0.4, -2.2], [0.0, 0.0, 0.0], 50.0)
    perm = morton_permutation(64, 64)[: b * t_dim]
    ro = tt(np.asarray(ro)[perm]).reshape(b, t_dim, 3).to(dev)
    rd = tt(np.asarray(rd)[perm]).reshape(b, t_dim, 3).to(dev)
    cs = torch.as_tensor(rng.normal(0, 0.3, (b, k_dim, 3)),
                         dtype=torch.float32, device=dev)
    # A handful of spheres must still be hit: make them larger.
    scale = 5.0 if k_dim < 50 else 1.0
    rs = torch.as_tensor(scale * (0.02 + 0.05 * rng.random((b, k_dim))),
                         dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.random((b, k_dim)) > 0.1, device=dev)
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    return ro, rd, cs, rs, qs


@pytest.mark.cuda
@pytest.mark.parametrize("k_dim", [5, 300, 2048, 5000, 8192])
def test_cuda_kernel_matches_plain(cuda_device, k_dim):
    """K <= 4096 keeps the table resident (K = 2,048 is config 4's budget);
    K = 5000 and 8,192 stage it chunk by chunk (and opt in to > 48 KB of
    shared memory). 250 rays per tile leave the last block of a tile
    ragged (a block marches 16 rays). At k = 128 around
    spheres of radius 0.02-0.07 the march's float32 noise reaches ~1e-2 in
    the normals, so each gap to the plain version is held to 5x the plain
    version's own gap to the same march in float64, plus 1e-5
    (kernel_cases.march_noise_tols), cold and then warm."""
    args = _cuda_case(cuda_device, 4, 250, k_dim, k_dim)
    t_init = None
    for steps in (40, 16):
        t_p = _k3_held(args, 128.0, steps, t_init, min_hits=51)
        t_init = t_p * 0.8


# The paths' own shapes (kernel_cases' inputs): config 4's 32 tiles of 512
# rays against top-2,048 tables of the 5,120-sphere knot cloud; the chunked
# path (8 of them against 8,192 live columns); the refine acceptance loss's
# 512 tiles (cold; held on 16 of them); config 5's 32 tiles of its 256² rig
# against top-4,096 tables of 51,200 spheres; the dry run's parts (d) and
# (e); the bench flagship's step (hierarchical top-256 of 51,200 spheres,
# 16 warm steps from the Trainer's prefilled t cache).
K3_PATHS = ("config4", "chunked", "acceptance", "config5", "dryrun_kernel",
            "dryrun_union", "flagship")


def _flagship_case(dev):
    """The bench flagship's step batch (tools/bench.flagship_config):
    sampled and sorted as the step samples it, in tiles against its
    hierarchical tables, at the last stage's smooth_k → (args, k, the warm
    start: the prefilled t cache x warm_backoff, warm steps)."""
    from burn_raymarching_tpu_torch.data.dataset import gather_batch
    from burn_raymarching_tpu_torch.models.scene import activate
    from burn_raymarching_tpu_torch.tools import bench
    from burn_raymarching_tpu_torch.tools import bench_large as bl
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from burn_raymarching_tpu_torch.train.step_body import (
        culled_tables,
        sample_step_indices,
        schedule_for_step,
    )

    cfg = bench.flagship_config()
    ds = bl.make_dataset(10 * 256 * 256, 256, dev)
    padded, mask = bl.make_params(kc.LARGE_INIT_N, dev)
    trainer = Trainer(cfg, ds, log=lambda s: None)
    trainer.t_cache = trainer._init_t_cache()
    trainer.prefill_t_cache(padded, mask, cfg.max_smooth_k)
    clusters = trainer._build_cluster_table(padded, mask)
    _, k, ratio, _ = schedule_for_step(cfg, cfg.stages - 1, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fg, n_fg = trainer._sample_fg
    idx = torch.sort(sample_step_indices(
        cfg, gen, ds.packed.shape[0], fg, n_fg, cfg.batch_size,
        ratio)).values
    ro, rd, _ = gather_batch(ds.packed, idx)
    b, tile = cfg.batch_size // cfg.cull_tile, cfg.cull_tile
    with torch.no_grad():
        c, _, r, _, _ = activate(padded)
        _, _, cs, rs, qs = culled_tables(cfg, ro, rd, c, r, k, mask,
                                         clusters)
    args = (ro.reshape(b, tile, 3), rd.reshape(b, tile, 3), cs, rs, qs)
    t0 = (trainer.t_cache[idx] * cfg.warm_backoff).reshape(b, tile, 1)
    return args, k, t0.contiguous(), cfg.warm_steps


def _k3_held(args, k, steps, t_init=None, pick=None, min_hits=1):
    """K3 on ``args`` against its plain version (on the tiles ``pick``
    only, when given) within kernel_cases.march_noise_tols, with at least
    ``min_hits`` rays that hit → the plain t."""
    kw = dict(num_steps=steps, t_init=t_init)
    before = k3.culled_march_normals.launches
    t_k, n_k = k3.culled_march_normals(*args, k, **kw)
    assert k3.culled_march_normals.launches == before + 1
    if pick is not None:
        t_k, n_k = t_k[pick], n_k[pick]
        args = [a[pick].contiguous() for a in args]
        t_init = None if t_init is None else t_init[pick].contiguous()
    t_p, n_p = tr.culled_march_normals_xla(*args, k, num_steps=steps,
                                           t_init=t_init)
    t_64, n_64 = tr.culled_march_normals_xla(
        *[a.double() for a in args], k, num_steps=steps,
        t_init=None if t_init is None else t_init.double())
    torch.cuda.synchronize()
    errs = kc.march_errors(t_k, n_k, t_p, n_p)
    assert errs["hit_rays"] >= min_hits, errs
    tols = kc.march_noise_tols(t_p, n_p, t_64, n_64)
    assert not kc.march_excess(errs, tols), (steps, errs, tols)
    return t_p


@pytest.mark.cuda
@pytest.mark.parametrize("path", K3_PATHS)
def test_cuda_kernel_at_the_paths_shapes(cuda_device, path):
    """K3 at each path's own tiles and tables (K3_PATHS), cold (40 steps,
    the dry run's march_steps) and, where the path warm-starts, warm (16
    steps, the dry run's warm_steps, from the warm start of the path: 0.8
    of the plain cold t, or warm_backoff of it, or the flagship's
    prefilled t cache), each against its plain version within 5x the plain
    version's own float32 gap to the same march in float64, plus 1e-5."""
    dev = cuda_device
    if path.startswith("dryrun"):
        (*args, k, cfg) = kc.dryrun_k3_inputs(dev)[path.split("_")[1]]
        t_cold = _k3_held(args, k, cfg.render.march_steps)
        _k3_held(args, k, cfg.warm_steps,
                 (t_cold * cfg.warm_backoff).contiguous())
        return
    if path == "flagship":
        args, k, t0, steps = _flagship_case(dev)
        _k3_held(args, k, steps, t0)
        return
    if path == "config5":
        _, mask, c, r = kc.knot_cloud(dev, 51200, gt_n=2000)
        args, _ = kc.c4_tiles(dev, c, r, mask, size=256, views=100,
                              budget=4096)
    else:
        _, mask, c, r = kc.knot_cloud(dev, kc.C4_INIT_N)
        if path == "acceptance":
            args, _ = kc.c4_tiles(dev, c, r, mask, tiles=512, draw=16)
            pick = torch.arange(0, 512, 32, device=dev)
            _k3_held(args, kc.C4_K, 40, pick=pick)
            return
        args, _ = kc.c4_tiles(dev, c, r, mask)
    if path == "chunked":
        _k3_held(kc.chunked_tiles(dev, args[0], args[1]), kc.C4_K, 16)
        return
    t_cold = _k3_held(args, kc.C4_K, 40)
    _k3_held(args, kc.C4_K, 16, (t_cold * 0.8).contiguous())

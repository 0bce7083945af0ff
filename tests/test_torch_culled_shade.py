"""K6, the culled training step's fused tail (ops/cuda/culled_shade_kernel.py,
csrc/culled_shade.cu), against its oracle, the port's own
render_diff_culled given ``precomputed``.

On the CPU: the kernels' arithmetic in plain PyTorch (``tail_forward``,
``tail_backward``: only each tile's live columns, lanes striding over them,
two forward passes with online minima, the hand-derived backward with the
row sums at p, the per-column sums over the rays and the l^ → light
projection) in float64 against autograd through render_diff_culled, on
tiles with no valid slot, every slot valid and valid slots that end before
K, at sharpness 10/15 and 40/60 (rtol 1e-9: the two differ by summation
order only); the step's dispatch predicate; and the wrapper on CPU tensors,
which is the plain tail, inside a culled step and alone.

On the card (``cuda``): the kernels against the plain tail at config 4's
shape (32 tiles x 512 rays, K = 2,048, tables from a real selection) and on
full tables (every one of 2,048 slots valid, staged in two chunks), within
5x the plain version's own float32 gap to float64 + 1e-5; two calls
bitwise equal; exact zeros for a tile without a valid slot and for invalid
slots, on the CPU tests' tiles; a culled stage replayed from captured
graphs against the same steps one at a time; and the counters of a
config-4 step with the tracer on.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch_parity import cuda_device, nn  # noqa: F401  (a fixture)

from burn_raymarching_tpu_torch.config import RenderConfig, TrainConfig
from burn_raymarching_tpu_torch.ops.cuda import culled_shade_kernel as k6
from burn_raymarching_tpu_torch.ops.cuda.culled_march_kernel import (
    culled_march_normals,
)
from burn_raymarching_tpu_torch.ops.culling import gather_tile_tables
from burn_raymarching_tpu_torch.render.culled import (
    culled_march_normals_xla,
    render_diff_culled,
)
from burn_raymarching_tpu_torch.train.step_body import (
    uses_fused_culled_shade,
)
from burn_raymarching_tpu_torch.utils.profiling import TRACER

B, T, K = 4, 24, 40
# Valid slots a tile: none, all, and two that end before K.
N_VALID = (0, K, 25, 5)
SHARPNESS = [(24.0, 10.0, 15.0), (128.0, 40.0, 60.0)]   # (k, a, c)
LANES = 16                                               # CT_LANES


def _tiles(dtype=torch.float64, seed=0):
    """B tiles of T rays toward a small scene, their K-slot tables (valid
    slots first), and t and normal from the plain culled march."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays

    rng = np.random.default_rng(seed)
    ros, rds = [], []
    for b in range(B):
        ro, rd = create_camera_rays(6, 4, [0.3 * b - 0.4, 0.4, -2.5],
                                    [0, 0, 0], 30.0, device="cpu")
        ros.append(ro)
        rds.append(rd)
    ro3 = torch.stack(ros).to(dtype)
    rd3 = torch.stack(rds).to(dtype)
    f = dict(dtype=dtype)
    cs = torch.as_tensor(rng.normal(0, 0.3, (B, K, 3)), **f)
    cols = torch.as_tensor(rng.random((B, K, 3)), **f)
    rs = torch.as_tensor(0.08 + 0.12 * rng.random((B, K)), **f)
    valid = torch.arange(K)[None, :] < torch.tensor(N_VALID)[:, None]
    light = torch.as_tensor([0.3, 1.0, -0.4], **f)
    amb = torch.as_tensor([0.25], **f)
    cot = torch.as_tensor(rng.normal(0, 1, (B * T, 3)), **f)
    return ro3, rd3, cs, cols, rs, valid, light, amb, cot


def _march(ro3, rd3, cs, rs, valid, k):
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    return culled_march_normals_xla(ro3, rd3, cs, rs, qs, k, num_steps=40)


def _dists(p, cq, r):
    """[T, n] surface distances of points p [T, 3] against columns cq [n, 4]
    = (c, |c|² or 1e30), in the expanded form, and the unclamped q."""
    px, py, pz = (p[:, i, None] for i in range(3))
    psq = (px * px + py * py) + pz * pz
    q = (psq + cq[None, :, 3]) - 2.0 * (
        px * cq[None, :, 0] + (py * cq[None, :, 1] + pz * cq[None, :, 2]))
    sq = torch.sqrt(torch.clamp(q, min=1e-6))
    return sq - r[None, :], q, sq


def _online(d, rates, cols=None):
    """One pass over the columns of d [T, n] as LANES lanes take them: a
    running minimum per lane and sums relative to it (a column at delta adds
    e = exp(−rate·|delta|) as s + e, or as s·e + 1 when it lowers the
    minimum; with ``cols`` the first rate's colour sums follow), merged by
    the overall minimum → (dmin, sums, colour sums)."""
    rows = d.shape[0]
    dm = torch.full((rows, LANES), torch.inf, dtype=d.dtype)
    sums = [torch.zeros((rows, LANES), dtype=d.dtype) for _ in rates]
    csum = torch.zeros((rows, LANES, 3), dtype=d.dtype)
    for j in range(d.shape[1]):
        lane, dj = j % LANES, d[:, j]
        delta = dj - dm[:, lane]
        lower = delta < 0
        for which, (s, rate) in enumerate(zip(sums, rates)):
            e = torch.exp(-rate * delta.abs())
            a, w = torch.where(lower, e, 1.0), torch.where(lower, 1.0, e)
            s[:, lane] = s[:, lane] * a + w
            if cols is not None and which == 0:
                csum[:, lane] = (csum[:, lane] * a[:, None]
                                 + w[:, None] * cols[j])
        dm[:, lane] = torch.minimum(dm[:, lane], dj)
    dmin = dm.amin(dim=1, keepdim=True)
    totals, cmix = [], None
    for which, (s, rate) in enumerate(zip(sums, rates)):
        scale = torch.exp(-rate * (dm - dmin))
        totals.append(torch.sum(s * scale, dim=1, keepdim=True))
        if which == 0:
            cmix = torch.sum(csum * scale[:, :, None], dim=1)
    return dmin, totals, cmix


def _softmin(dmin, s, k):
    return (torch.log(torch.clamp(s, min=1e-8)) + dmin * (-k)) / (-k)


def _columns(cs, cols, rs, valid, b):
    """Tile b's live columns: (n, cq [n, 4], r [n], colours [n, 3])."""
    live = torch.nonzero(valid[b])
    n = int(live.max()) + 1 if live.numel() else 0
    c = cs[b, :n]
    csq = torch.where(valid[b, :n], torch.sum(c * c, dim=1),
                      torch.full_like(rs[b, :n], 1e30))
    return n, torch.cat([c, csq[:, None]], dim=1), rs[b, :n], cols[b, :n]


def _light(light, amb, normal):
    norm = torch.sqrt(torch.sum(light * light))
    lhat = light / norm
    dot = torch.sum(normal * lhat, dim=1, keepdim=True)
    diff = torch.clamp(dot, min=0.0)
    return lhat, norm, dot, diff, amb + diff * (1.0 - amb)


def tail_forward(ro3, rd3, t, normal, cs, cols, rs, valid, light, amb, k, a,
                 c):
    """The forward kernel's arithmetic → (out [B T, 3], per tile the state
    (dmin0, s0, dmin, s_a, s_k, mix) or None for a tile without a valid
    slot, whose rays shade 0)."""
    outs, states = [], []
    for b in range(ro3.shape[0]):
        n, cq, r, col = _columns(cs, cols, rs, valid, b)
        if n == 0:
            outs.append(torch.zeros_like(ro3[b]))
            states.append(None)
            continue
        p0 = ro3[b] + rd3[b] * t[b]
        dmin0, (s0,), _ = _online(_dists(p0, cq, r)[0], (k,))
        s0 = torch.clamp(s0, min=1e-8)
        p = ro3[b] + rd3[b] * (t[b] + _softmin(dmin0, s0, k))
        dmin, (sa, sk), csum = _online(_dists(p, cq, r)[0], (a, k), col)
        sk = torch.clamp(sk, min=1e-8)
        mix = csum / sa
        lighting = _light(light, amb, normal[b])[4]
        cov = 1.0 / (1.0 + torch.exp(_softmin(dmin, sk, k) * c))
        outs.append(mix * lighting * cov)
        states.append((dmin0, s0, dmin, sa, sk, mix))
    return torch.cat(outs), states


def tail_backward(ro3, rd3, t, normal, cs, cols, rs, valid, light, amb, k, a,
                  c, states, g):
    """The backward kernel's arithmetic → (d_centers_t, d_colors_t,
    d_radii_t, d_light, d_ambient). Per tile: the per-ray scalars from the
    saved state; the row sums at p give dL/dp and the reattachment's scale;
    each live column sums its seven gradients over the rays; the rest of
    the table gets exactly 0."""
    d_c, d_col, d_r = (torch.zeros_like(x) for x in (cs, cols, rs))
    d_lhat = torch.zeros(3, dtype=g.dtype)
    d_amb = torch.zeros(1, dtype=g.dtype)
    g3 = g.reshape(ro3.shape)
    lhat, norm = _light(light, amb, normal[0])[:2]
    for b, st in enumerate(states):
        if st is None:
            continue
        n, cq, r, col = _columns(cs, cols, rs, valid, b)
        dmin0, s0, dmin, sa, sk, mix = st
        p0 = ro3[b] + rd3[b] * t[b]
        p = ro3[b] + rd3[b] * (t[b] + _softmin(dmin0, s0, k))
        _, _, dot, diff, lighting = _light(light, amb, normal[b])
        cov = 1.0 / (1.0 + torch.exp(_softmin(dmin, sk, k) * c))
        g_mix = torch.sum(g3[b] * mix, dim=1, keepdim=True)
        dm = g3[b] * lighting * cov
        d_lighting, d_cov = g_mix * cov, g_mix * lighting
        d_dot = torch.where(dot >= 0, d_lighting * (1.0 - amb), 0.0)
        d_lhat += torch.sum(d_dot * normal[b], dim=0)
        d_amb += torch.sum(d_lighting * (1.0 - diff))
        wsum = torch.sum(dm * mix, dim=1, keepdim=True)
        d_ds = d_cov * (-c) * cov * (1.0 - cov)
        d, q, sq = _dists(p, cq, r)
        w = torch.exp(-a * (d - dmin)) / sa
        v = torch.exp(-k * (d - dmin)) / sk
        d_d = -a * w * (dm @ col.T - wsum) + d_ds * v
        dq = torch.where(q >= 1e-6, d_d * 0.5 / sq, 0.0)
        dp = 2.0 * (p * dq.sum(dim=1, keepdim=True) - dq @ cq[:, :3])
        scale0 = torch.sum(rd3[b] * dp, dim=1, keepdim=True) / s0
        d0, q0, sq0 = _dists(p0, cq, r)
        dd0 = torch.exp(-k * (d0 - dmin0)) * scale0
        dq0 = torch.where(q0 >= 1e-6, dd0 * 0.5 / sq0, 0.0)
        live = valid[b, :n, None]
        # sum_i 2 dq_ij (c_j - p_i), at p and at p0
        gc = 2.0 * (cq[:, :3] * (dq + dq0).sum(dim=0)[:, None]
                    - dq.T @ p - dq0.T @ p0)
        d_c[b, :n] = torch.where(live, gc, 0.0)
        d_r[b, :n] = torch.where(live[:, 0], -(d_d + dd0).sum(dim=0), 0.0)
        d_col[b, :n] = torch.where(live, w.T @ dm, 0.0)
    along = torch.sum(lhat * d_lhat)
    return d_c, d_col, d_r, (d_lhat - lhat * along) / norm, d_amb


def _leaves(cs, cols, rs, light, amb):
    return [x.detach().clone().requires_grad_() for x in
            (cs, cols, rs, light, amb)]


@pytest.mark.parametrize("k,a,c", SHARPNESS)
def test_the_kernels_arithmetic_matches_the_plain_tail_in_float64(k, a, c):
    ro3, rd3, cs, cols, rs, valid, light, amb, cot = _tiles()
    t, normal = _march(ro3, rd3, cs, rs, valid, k)
    leaves = _leaves(cs, cols, rs, light, amb)
    want = k6.culled_shade_plain(ro3, rd3, t, normal, leaves[0], leaves[1],
                                 leaves[2], valid, leaves[3], leaves[4], k, a,
                                 c)
    want_grads = torch.autograd.grad(torch.sum(want * cot), leaves)
    out, states = tail_forward(ro3, rd3, t, normal, cs, cols, rs, valid,
                               light, amb, k, a, c)
    grads = tail_backward(ro3, rd3, t, normal, cs, cols, rs, valid, light,
                          amb, k, a, c, states, cot)
    assert states[0] is None and all(s is not None for s in states[1:])
    np.testing.assert_array_equal(nn(want[:T]), 0.0)
    # Coverage must not vanish everywhere, or the gradients test nothing.
    assert float(torch.abs(want[T:].detach()).max()) > 0.05
    for got, ref in zip((out, *grads), (want, *want_grads)):
        scale = float(torch.abs(ref.detach()).max())
        np.testing.assert_allclose(nn(got), nn(ref), rtol=1e-9,
                                   atol=1e-9 * scale)
    for grad in want_grads[:3]:
        # The tile without a valid slot and every invalid slot get exactly 0.
        np.testing.assert_array_equal(nn(grad[~valid]), 0.0)


def _step_cfg(**kw) -> TrainConfig:
    render = kw.pop("render", {})
    kw = {"use_culling": True, "use_fused_shade": True, **kw}
    return TrainConfig(render=dataclasses.replace(RenderConfig(), **render),
                       **kw)


@pytest.mark.parametrize("cfg_kw,k3,axis,want", [
    ({}, True, None, True),
    ({"render": {"softmax_sharpness": 40.0, "mask_sharpness": 60.0}}, True,
     None, True),
    ({"render": {"mask_pixel_mult": 1.5}}, True, None, True),
    ({"render": {"pixel_angle": 0.002}}, True, None, True),
    ({"render": {"mask_pixel_mult": 1.5, "pixel_angle": 0.002}}, True, None,
     False),
    ({"render": {"coverage_mode": "gaussian"}}, True, None, False),
    ({}, True, "model", False),
    ({}, False, None, False),
    ({"use_fused_shade": False}, True, None, False),
    ({"use_culling": False}, True, None, False),
], ids=["reference", "c4", "mask_px_only", "pixel_angle_only",
        "pixel_footprint", "gaussian", "model_axis", "no_k3", "fused_off",
        "dense"])
def test_the_step_picks_the_fused_culled_tail_exactly_where_it_computes_it(
        cfg_kw, k3, axis, want):
    cfg = _step_cfg(**cfg_kw)
    assert uses_fused_culled_shade(cfg, culled_march_normals if k3 else None,
                                   object() if axis else None) is want


@pytest.mark.parametrize("k,a,c", SHARPNESS)
def test_the_wrapper_on_cpu_tensors_is_the_plain_tail(k, a, c):
    """On CPU tensors the wrapper, on tables gathered from the scene, equals
    render_diff_culled on the scene, value and gradients bitwise."""
    ro3, rd3, cs, cols, rs, valid, light, amb, cot = _tiles(torch.float32)
    t, normal = _march(ro3, rd3, cs, rs, valid, k)
    rng = np.random.default_rng(3)
    m = 40
    scene = [torch.as_tensor(rng.normal(0, 0.3, (m, 3)), dtype=torch.float32),
             torch.as_tensor(rng.random((m, 3)), dtype=torch.float32),
             torch.as_tensor(0.08 + 0.12 * rng.random((m, 1)),
                             dtype=torch.float32), light, amb]
    idx = torch.as_tensor(rng.integers(0, m, (B, K)))

    def run(tail):
        leaves = _leaves(*scene)
        out = tail(leaves)
        return [out.detach(), *torch.autograd.grad(torch.sum(out * cot),
                                                   leaves)]

    def fused(p):
        ct, colt, rt, _ = gather_tile_tables(p[0], p[1], p[2], idx, valid)
        return k6.culled_shade(ro3, rd3, t, normal, ct, colt, rt, valid, p[3],
                               p[4], k, a, c)

    def plain(p):
        return render_diff_culled(
            ro3.reshape(-1, 3), rd3.reshape(-1, 3), *p, k, tile=T,
            k_budget=K, softmax_sharpness=a, mask_sharpness=c,
            precomputed=(idx, valid, t, normal))

    for got, want in zip(run(fused), run(plain)):
        np.testing.assert_array_equal(nn(got), nn(want))


def _culled_trainer(tmp_path, device, **kw):
    """A small culled trainer (the knot-free generator scene at 128², tile
    sampling, the warm march) on ``device``."""
    from burn_raymarching_tpu_torch.tools import generate
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    out = str(tmp_path / "data")
    if not os.path.exists(os.path.join(out, "cameras.json")):
        generate.main(["--out", out, "--size", "128", "--device", "cpu"])
    kw = {"width": 128, "height": 128, "batch_size": 4096,
          "use_culling": True, "cull_tile": 512, "cull_budget": 64,
          "sample_mode": "tile", "dataset_order": "morton",
          "warm_start": True, "warm_steps": 16, "init_n": 300,
          "init_layout": "cloud", "steps_per_stage": 100,
          "checkpoint_dir": "", **kw}
    cfg = TrainConfig(cameras_json=os.path.join(out, "cameras.json"), **kw)
    return Trainer(cfg, build_dataset(cfg, device=device), log=lambda m: None)


def _runner(tr, seed=5, graphs=True):
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
    from burn_raymarching_tpu_torch.train.optimizer import make_optimizer
    from burn_raymarching_tpu_torch.train.step_body import lr_scale_tree

    padded, mask = pad_params(tr._init_params(), 512)
    fg, n_fg = tr._sample_fg
    if tr.warm:
        tr.prefill_t_cache(padded, mask, 128.0)
    return ChunkRunner(
        tr.step_fn, padded, make_optimizer(tr.cfg, padded),
        lr_scale_tree(tr.cfg, 0), 0, mask, tr.dataset.packed, fg, n_fg,
        torch.Generator(device=tr.device).manual_seed(seed),
        t_cache=tr.t_cache, graphs=graphs)


def test_a_culled_cpu_step_with_the_k3_wrapper_counts_the_fused_tail(
        tmp_path):
    """On the CPU, a culled step given the K3 wrapper dispatches to the
    fused tail (whose CPU path is the plain tail: the step's loss and
    gradients are bitwise those of the step that takes render_diff_culled)
    and counts ``tail.fused``; with use_fused_shade off it counts
    ``tail.plain``."""
    from burn_raymarching_tpu_torch.models.scene import pad_params
    from burn_raymarching_tpu_torch.train.step_body import make_device_step

    tr = _culled_trainer(tmp_path, "cpu", batch_size=1024, cull_tile=256,
                         warm_start=False)
    padded, mask = pad_params(tr._init_params(), 512)
    fg, n_fg = tr._sample_fg
    results = {}
    for fused in (True, False):
        cfg = dataclasses.replace(tr.cfg, use_fused_shade=fused)
        step = make_device_step(cfg, march_normal_fn=None,
                                batch=cfg.batch_size,
                                culled_march_fn=culled_march_normals)
        TRACER.reset()
        TRACER.enable()
        try:
            loss, _ = step(padded, torch.Generator().manual_seed(2), 0, 1,
                           mask, tr.dataset.packed, fg, n_fg)
            counters = dict(TRACER.counters)
        finally:
            TRACER.disable()
            TRACER.reset()
        results[fused] = [nn(loss)] + [nn(p.grad) for p in
                                       padded.parameters()]
        name = "tail.fused" if fused else "tail.plain"
        assert counters.get(name) == 1
        assert counters.get("tail.plain" if fused else "tail.fused") is None
    for a, b in zip(results[True], results[False]):
        np.testing.assert_array_equal(a, b)


# --- on the card ---------------------------------------------------------- #

def _card_case(dev, shape: str):
    """chip_smoke.py's K6 inputs: config 4's tiles and tables (32 Morton
    tiles of 512 rays of the 30-view 512² knot rig, K = 2,048 from a real
    selection over 5,120 knot-seeded spheres), or ``full_tables``: the
    first 4 of them each against 2,048 valid slots; t and normal from K3.
    ``small``: the CPU tests' tiles (a tile without a valid slot, 24 rays a
    tile: a ray block half filled)."""
    import chip_smoke

    if shape == "small":
        ro3, rd3, cs, cols, rs, valid, light, amb, cot = _tiles(torch.float32)
        t, normal = _march(ro3, rd3, cs, rs, valid, chip_smoke.C4_K)
        return (tuple(x.to(dev) for x in (ro3, rd3, t, normal, cs, cols, rs,
                                          valid, light, amb)), cot.to(dev))
    _, mask, c, r = chip_smoke.knot_cloud(torch, dev, chip_smoke.C4_INIT_N)
    args, _ = chip_smoke.c4_tiles(torch, dev, c, r, mask)
    if shape == "full_tables":
        args = chip_smoke.full_tables(torch, args, c, r, mask)
    return chip_smoke.k6_inputs(torch, dev, args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["c4", "full_tables"])
def test_cuda_kernels_match_the_plain_tail(cuda_device, shape):
    """Value and all five gradients within 5x the plain version's float32
    gap to float64 + 1e-5; a second call bitwise equal."""
    from chip_smoke import K6_GRADS, k6_run

    inp, cot = _card_case(cuda_device, shape)
    got = k6_run(torch, k6.culled_shade, inp, cot)
    plain = k6_run(torch, k6.culled_shade_plain, inp, cot)
    plain64 = k6_run(torch, k6.culled_shade_plain, inp, cot, torch.float64)
    before = k6.launch_ctail_bwd.launches
    again = k6_run(torch, k6.culled_shade, inp, cot)
    torch.cuda.synchronize()
    assert k6.launch_ctail_bwd.launches == before + 1
    for name, g, p, p64, a in zip(("out",) + K6_GRADS, got, plain, plain64,
                                  again):
        tol = 5.0 * float(torch.abs(p.double() - p64).max()) + 1e-5
        err = float(torch.abs(g - p).max())
        assert err <= tol, f"{name}: {err} > {tol}"
        np.testing.assert_array_equal(nn(g), nn(a))


@pytest.mark.cuda
def test_cuda_empty_tile_and_invalid_slots_get_exact_zeros(cuda_device):
    """On the CPU tests' tiles (one without a valid slot, 24 rays a tile, so
    a ray block is half filled): the empty tile shades exactly 0, it and
    every invalid slot get exactly 0 gradient, and everything is finite."""
    from chip_smoke import k6_run

    inp, cot = _card_case(cuda_device, "small")
    out, d_c, d_col, d_r, d_l, d_amb = k6_run(torch, k6.culled_shade, inp,
                                              cot)
    valid = inp[7]
    np.testing.assert_array_equal(nn(out[:T]), 0.0)
    for grad in (d_c, d_col, d_r):
        np.testing.assert_array_equal(nn(grad[~valid]), 0.0)
    for x in (out, d_c, d_col, d_r, d_l, d_amb):
        assert bool(torch.isfinite(x).all())
    assert float(out[T:].abs().max()) > 0.05


@pytest.mark.cuda
def test_cuda_captured_culled_stage_matches_one_step_at_a_time(
        cuda_device, tmp_path):
    """Ten culled steps with config 4's compositor (K3, K4, K6), replayed
    from a captured graph and run one step at a time from one state and
    generator: the last loss and gradients, and the parameters, bitwise
    equal; K6 launched once a step and once more for the warm-up."""
    tr = _culled_trainer(tmp_path, cuda_device, render=dataclasses.replace(
        RenderConfig(), softmax_sharpness=40.0, mask_sharpness=60.0))
    runs = []
    for graphs in (True, False):
        runner = _runner(tr, graphs=graphs)
        before = k6.launch_ctail_fwd.launches, k6.launch_ctail_bwd.launches
        runner.run(1, 10)
        torch.cuda.synchronize()
        after = k6.launch_ctail_fwd.launches, k6.launch_ctail_bwd.launches
        assert after == tuple(n + 10 + graphs for n in before)
        runs.append([float(runner.loss)]
                    + [nn(p) for p in runner.params.parameters()]
                    + [nn(p.grad) for p in runner.params.parameters()])
        runner.close()
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1:], runs[1][1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_config4_steps_count_the_fused_tail(cuda_device, tmp_path):
    """With the tracer on, captured culled steps at config 4's compositor
    count ``tail.fused`` once a step replayed and no ``tail.plain``."""
    tr = _culled_trainer(tmp_path, cuda_device, render=dataclasses.replace(
        RenderConfig(), softmax_sharpness=40.0, mask_sharpness=60.0))
    TRACER.reset()
    TRACER.enable()
    try:
        runner = _runner(tr)
        runner.run(1, 4)
        torch.cuda.synchronize()
        counters = TRACER.records()["counters"]
        runner.close()
    finally:
        TRACER.disable()
        TRACER.reset()
    assert counters["tail.fused"] == counters["steps"] == 4
    assert "tail.plain" not in counters

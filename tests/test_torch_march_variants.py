"""K5: the port's variant_march against scripts/exp_march_variants.py's
variant_march, and the port's two march tools.

The JAX function is loaded by path and runs unmodified in TPU interpret mode
(``force_tpu_interpret_mode``) on the CPU; on CPU tensors the port's wrapper
runs its plain version. Both get the same numpy inputs: 128 rays, 16 slots
of which 4 are masked (c_sq = 1e30; the ``coord`` variants get far centers
at 1e15, as the script's ``prim_far``), 8 steps, tile_n = 64, in all eight
``clamp`` / ``exp2`` / ``coord`` combinations.

Tolerances, on the rays that hit (t < 10 in the JAX result; missed rays'
t and normals are the divergent tail of the march): t rtol and atol 1e-5;
normals atol 1e-3, or twice the plain float32 version's own largest gap to
the same march in float64 where that is larger. After 8 steps most rays
are still short of the surface: there |d| of the central difference
(~2e-4) is far under the 1e-3 that the +1e-6 inside the length's sqrt
adds, so the normal is ~1,000 d, and the soft-min's float32 rounding
(~1e-7 of values up to ~1) becomes ~1e-3 (on this input the plain float32
march is 1.6e-3 from float64 in the normals, the JAX one 2.0e-3).
The CUDA kernel (K1's march core with the three switches) is held on the
card by the cuda-marked tests (``pytest -m cuda
tests/test_torch_march_variants.py``): against the plain version within 5x
the plain float32 version's own gap to the same march in float64, plus
1e-5 (kernel_cases.march_noise_tols, the rule for K1, K3 and K5: the SFU's
approximate sqrt and exp move t on hit rays by ~1e-3 at 40 steps, as they
move K1), bitwise equal across tile sizes, ``base`` bitwise equal to K1 on
the same table, and past one staged chunk of slots. The CPU test of the
one-pass soft-min holds the arithmetic the kernel uses in place of the
two-pass row max, at every lane count the launch rule can pick.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import cuda_device, nn, tt  # noqa: F401  (fixture)

from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.models.scene import activate as j_activate
from burn_raymarching_tpu.models.scene import init_scene_params as j_init
from burn_raymarching_tpu.models.scene import pad_params as j_pad
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
from burn_raymarching_tpu_torch.ops.cuda import march_variants_kernel as k5
from burn_raymarching_tpu_torch.tools import exp_march_variants, roofline
from burn_raymarching_tpu_torch.tools import kernel_cases as kc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SIDE_W, N_SIDE_H, M, LIVE, STEPS, TILE, K = 16, 8, 16, 12, 8, 64, 18.5
FLAGS = [(c, e, x) for c in (False, True) for e in (False, True)
         for x in (False, True)]
IDS = ["+".join(name for name, on in zip(("clamp", "exp2", "coord"), flags)
              if on) or "base" for flags in FLAGS]
T_TOL = 1e-5
NORMAL_ATOL = 1e-3
# The lane counts the kernel's launch rule (common.cuh pick_lanes) picks.
LANES = (1, 2, 4, 8, 16, 32)


@pytest.fixture(scope="module")
def jax_script():
    """scripts/exp_march_variants.py as a module (jax and numpy at module
    level; its main is not called)."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_march_variants",
        os.path.join(ROOT, "scripts", "exp_march_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    """numpy float32 inputs of variant_march: a 16 x 8 camera at the scene,
    12 live spheres of the script's distribution in 16 slots."""
    rng = np.random.default_rng(0)
    ro, rd = create_camera_rays(N_SIDE_W, N_SIDE_H, [0.0, 0.5, -2.5],
                                [0, 0, 0], 50.0, device="cpu")
    c = np.zeros((M, 3), np.float32)
    c[:LIVE] = rng.normal(0, 0.3, (LIVE, 3))
    raw = np.zeros(M, np.float32)
    raw[:LIVE] = rng.normal(-2.0, 0.3, LIVE)
    r = (np.log1p(np.exp(raw)) + 0.01).astype(np.float32)
    valid = np.arange(M) < LIVE
    c_far = np.where(valid[:, None], c, 1e15).astype(np.float32)
    return {"ro": ro.numpy(), "rd": rd.numpy(),
            "t0": np.zeros((N_SIDE_W * N_SIDE_H, 1), np.float32),
            "prim": np.ascontiguousarray(np.concatenate([c.T, r[None]])),
            "prim_far": np.ascontiguousarray(np.concatenate([c_far.T,
                                                             r[None]])),
            "c_sq": np.where(valid, (c * c).sum(1), 1e30)[None].astype(
                np.float32),
            "k": np.full((1, 1), K, np.float32)}


def _args(inputs, coord: bool) -> list:
    return [inputs[key] for key in ("ro", "rd", "t0")] + [
        inputs["prim_far" if coord else "prim"], inputs["c_sq"],
        inputs["k"]]


@pytest.mark.parametrize("flags", FLAGS, ids=IDS)
def test_plain_matches_jax_variant_march(jax_script, inputs, flags):
    clamp, exp2, coord = flags
    args = _args(inputs, coord)
    with pltpu.force_tpu_interpret_mode():
        t_j, n_j = jax_script.variant_march(
            *map(jnp.asarray, args), STEPS, TILE, clamp, exp2, coord)
    t_j, n_j = np.asarray(t_j), np.asarray(n_j)
    t_p, n_p = k5.variant_march(*map(tt, args), STEPS, TILE, clamp, exp2,
                                coord)
    t_64, n_64 = k5.variant_march_plain(*(tt(a).double() for a in args),
                                        STEPS, TILE, clamp, exp2, coord)
    hit = t_j[:, 0] < 10.0
    assert 20 < hit.sum()
    # The plain version is the port's CPU path: the wrapper ran it.
    assert np.array_equal(nn(t_p), nn(k5.variant_march_plain(
        *map(tt, args), STEPS, TILE, clamp, exp2, coord)[0]))
    assert np.isfinite(nn(t_p)).all() and np.isfinite(nn(n_p)).all()
    assert np.array_equal(nn(t_p)[:, 0] < 10.0, hit)
    np.testing.assert_allclose(nn(t_p)[hit], t_j[hit], rtol=T_TOL,
                               atol=T_TOL)
    noise = np.abs(nn(n_p) - nn(n_64))[hit].max()
    np.testing.assert_allclose(nn(n_p)[hit], n_j[hit],
                               atol=max(NORMAL_ATOL, 2.0 * noise))


def test_tile_must_divide_the_rays(inputs):
    """The TPU grid n // tile_n drops a remainder of rays; the port raises."""
    args = [tt(a) for a in _args(inputs, False)]
    with pytest.raises(ValueError, match="does not divide"):
        k5.variant_march(*args, STEPS, 48, False, False, False)
    with pytest.raises(ValueError, match="does not divide"):
        k5.variant_march_plain(*args, STEPS, 0, False, False, False)


def _online(sqrt_q: torch.Tensor, r: torch.Tensor, clamp: bool, exp2: bool,
            k: float, lanes: int) -> torch.Tensor:
    """The soft-min of csrc/common.cuh's march core as K5 runs it, in plain
    PyTorch, from sqrt(q) [N, M] and the radii [1, M]: per pair v = sqrt(q)
    (-k) + r k, with k log2(e) in place of k under exp2 (the kernel folds
    it into the scale, so v, the max and the sum are in base 2); ``lanes``
    lanes stride over the slots; clamp sums 2^min(v, 80 log2 e) (exp(min(v,
    80))) per lane; otherwise each lane keeps a running max and a sum
    relative to it; the lanes are merged by the overall max."""
    if exp2:
        k = float(torch.tensor(k) * torch.tensor(k5.LOG2E))
    val = sqrt_q * (-k) + r * k
    ex, lg = (torch.exp2, torch.log2) if exp2 else (torch.exp, torch.log)
    n, m_cols = val.shape
    s = torch.zeros((n, lanes), dtype=val.dtype)
    if clamp:
        ceiling = 80.0 * k5.LOG2E if exp2 else 80.0
        for j in range(m_cols):
            s[:, j % lanes] += ex(torch.clamp(val[:, j], max=ceiling))
        total = s.sum(1, keepdim=True)
        return lg(torch.clamp(total, min=1e-8)) / (-k)
    m = torch.full((n, lanes), -torch.inf, dtype=val.dtype)
    for j in range(m_cols):
        lane, v = j % lanes, val[:, j]
        d = v - m[:, lane]
        e = ex(-d.abs())
        s[:, lane] = torch.where(d > 0, s[:, lane] * e + 1.0, s[:, lane] + e)
        m[:, lane] = torch.maximum(m[:, lane], v)
    mx = m.amax(dim=1, keepdim=True)
    total = torch.sum(s * ex(m - mx), dim=1, keepdim=True)
    return (lg(torch.clamp(total, min=1e-8)) + mx) / (-k)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("flags", FLAGS[:4] + FLAGS[4::2], ids=IDS[:4]
                         + IDS[4::2])
def test_one_pass_soft_min_matches_two_pass(inputs, flags, lanes):
    """The kernel's one-pass soft-min against the plain two-pass one, on
    points along the rays from the scene's inside to past it, at every lane
    count the launch can pick (float32 rounding only: rtol 1e-5, atol
    1e-6)."""
    clamp, exp2, coord = flags
    prim = tt(inputs["prim_far" if coord else "prim"])
    c_sq = tt(inputs["c_sq"])
    ro, rd = tt(inputs["ro"]), tt(inputs["rd"])
    p = torch.cat([ro + rd * t for t in (1.5, 2.5, 3.5, 8.0)])
    kr = prim[3:4] * K
    two = k5._soft_min_rows(p, prim[:3], kr, c_sq, torch.tensor(K),
                            clamp=clamp, exp2=exp2, coord=coord)
    if coord:
        q = ((p[:, None, :] - prim[:3].T[None]) ** 2).sum(-1)
    else:
        q = (p * p).sum(1, keepdim=True) + c_sq - 2.0 * (p @ prim[:3])
    sqrt_q = torch.sqrt(torch.clamp(q, min=1e-6))
    np.testing.assert_allclose(
        nn(_online(sqrt_q, prim[3:4], clamp, exp2, K, lanes)), nn(two),
        rtol=1e-5, atol=1e-6)


def test_tool_scene_is_the_scripts(inputs):
    """The tools' scene and rays, built by the port's own modules, equal the
    JAX scripts' (scripts/exp_march_variants.py:164-176; scripts/roofline
    .py:56-64 builds the same centers and radii) at a small camera."""
    size = 8
    inp = exp_march_variants.make_inputs(size, "cpu")
    rng = np.random.default_rng(0)
    p = j_init(100)
    p.centers = jnp.asarray(rng.normal(0, 0.3, (100, 3)), jnp.float32)
    p.radii = jnp.asarray(rng.normal(-2.0, 0.3, (100, 1)), jnp.float32)
    padded, mask = j_pad(p, 128)
    c, _, r, _, _ = j_activate(padded)
    ro, rd = j_rays(size, size, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    np.testing.assert_array_equal(nn(inp["mask"]), np.asarray(mask))
    np.testing.assert_allclose(nn(inp["ro"]), np.asarray(ro), atol=1e-7)
    np.testing.assert_allclose(nn(inp["rd"]), np.asarray(rd), atol=1e-6)
    np.testing.assert_allclose(nn(inp["prim"][:3]), np.asarray(c).T,
                               atol=1e-7)
    np.testing.assert_allclose(nn(inp["prim"][3]), np.asarray(r)[:, 0],
                               rtol=1e-6)
    csq = np.where(np.asarray(mask), (np.asarray(c) ** 2).sum(1), 1e30)
    np.testing.assert_allclose(nn(inp["c_sq"])[0], csq, rtol=1e-6)
    far = nn(inp["prim_far"])
    assert (far[:3, 100:] == 1e15).all()
    np.testing.assert_array_equal(far[:, :100], nn(inp["prim"])[:, :100])
    np.testing.assert_array_equal(nn(inp["centers"]),
                                  np.asarray(padded.centers))


def test_exp_march_variants_main_cpu(capsys):
    out = exp_march_variants.main(["--device", "cpu", "--size", "16"])
    text = capsys.readouterr().out
    assert out["rays"] == 256 and out["slots"] == 128
    assert out["check_tile"] == 256
    assert out["card"].startswith("cpu")
    base = out["base_vs_plain_march"]
    # The base variant is the plain march's function: on hit rays the two
    # differ by float32 rounding only.
    assert base["hit_rays"] > 50
    assert base["max_dt_hit"] < 1e-4 and base["max_dn_hit"] < 5e-3
    assert set(out["deviation"]) == set(exp_march_variants.VARIANTS) - {
        "base"}
    # exp2 changes rounding only; clamp stalls the far rays at the floor.
    assert out["deviation"]["exp2"]["p50_dt"] < 1e-5
    assert out["deviation"]["clamp"]["max_dt"] > 1.0
    assert "deviation vs base kernel" in text
    assert text.count("not measured  [cpu: not a device time]") == 3 * 8
    assert text.count("does not divide 256 rays: skipped") == 4 * 8
    assert all(v == {64: None, 128: None, 256: None}
               for v in out["ms"].values())


def test_roofline_main_cpu(capsys):
    out = roofline.main(["--device", "cpu", "--size", "8"])
    text = capsys.readouterr().out
    assert out["rays"] == 64 and out["slots"] == 128
    assert out["floor_ms"] is None
    assert out["xcend_ms"] == {40: None, 16: None}
    assert out["march_ms"] == {40: None, 16: None}
    assert out["ratio"] == {40: None, 16: None}
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert len(lines) == 5
    assert all(ln.endswith("[cpu: not a device time]") for ln in lines)
    assert lines[0].startswith("scan floor: not measured")
    assert "exp+sqrt stream, 64x128: 40 passes not measured" in lines[1]


def _hold_to_float64_noise(args, steps, flags, t_k, n_k):
    """K5's t and normals against the plain version on the same inputs,
    each within 5x the plain float32 version's own gap to the same march in
    float64, plus 1e-5 (hit rays, t < 10: t and normals; all rays: t
    relative to 1 + t)."""
    t_p, n_p = k5.variant_march_plain(*args, steps, 1, *flags)
    t_64, n_64 = k5.variant_march_plain(*(a.double() for a in args), steps,
                                        1, *flags)
    torch.cuda.synchronize()
    assert int((t_64[:, 0] < 10.0).sum()) > 20
    errs = kc.march_errors(t_k, n_k, t_p, n_p)
    tols = kc.march_noise_tols(t_p, n_p, t_64, n_64)
    assert not kc.march_excess(errs, tols), (errs, tols)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS, ids=IDS)
def test_cuda_kernel_matches_plain(inputs, cuda_device, flags):
    """K5 against its plain version on the card (one launch, counted) under
    the float64-noise rule, and bitwise equal at other tile sizes (a ray's
    arithmetic does not depend on its block)."""
    clamp, exp2, coord = flags
    dev = cuda_device
    args = [tt(a).to(dev) for a in _args(inputs, coord)]
    before = k5.variant_march.launches
    t_k, n_k = k5.variant_march(*args, STEPS, TILE, clamp, exp2, coord)
    assert k5.variant_march.launches == before + 1
    _hold_to_float64_noise(args, STEPS, flags, t_k, n_k)
    for tile in (1, 32, 128):
        t_b, n_b = k5.variant_march(*args, STEPS, tile, clamp, exp2, coord)
        assert torch.equal(t_b, t_k) and torch.equal(n_b, n_k)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [M, 128])
def test_cuda_base_is_k1(inputs, cuda_device, slots):
    """K5's base on K1's table gives K1's t and normals bit for bit: at the
    test's 16 slots (128 rays, 16 lanes a ray) and at the tool's 128 (its
    16,384 rays, 8 lanes). Both read the table K1's pack kernel makes: K5's
    centers from its columns 0-2, c_sq from column 3, the radii as given."""
    dev = cuda_device
    if slots == M:
        ro, rd = (tt(inputs[key]).to(dev) for key in ("ro", "rd"))
        prim = tt(inputs["prim"]).to(dev)
        c, r = prim[:3].T.contiguous(), prim[3:4].T.contiguous()
        mask = torch.arange(M, device=dev) < LIVE
    else:
        inp = exp_march_variants.make_inputs(128, dev)
        ro, rd, c, r, mask = (inp[key] for key in ("ro", "rd", "centers",
                                                   "radii", "mask"))
    table = k1.pack_march_table(c, r, mask, K)
    prim = torch.cat([table[:, :3].T, r.reshape(1, -1)]).contiguous()
    c_sq = table[:, 3:4].T.contiguous()
    t0 = torch.zeros((ro.shape[0], 1), device=dev)
    t_1, n_1 = k1.march_shade(ro, rd, c, r, K, mask=mask, num_steps=40)
    t_5, n_5 = k5.variant_march(ro, rd, t0, prim, c_sq, K, 40, 64, False,
                                False, False)
    torch.cuda.synchronize()
    # Some rays hit (8 of the 128 at 16 slots) and some leave the scene.
    assert 0 < int((t_1[:, 0] < 10.0).sum()) < ro.shape[0]
    assert torch.equal(t_5, t_1), (t_5 - t_1).abs().max().item()
    assert torch.equal(n_5, n_1), (n_5 - n_1).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS, ids=IDS)
def test_cuda_chunked_table(inputs, cuda_device, flags):
    """3,000 slots (2,870 live, the last live one at 2,899): past the
    kernel's 1,024-column shared-memory chunk, so the table is staged chunk
    by chunk in every evaluation; against the plain version under the
    float64-noise rule, at the test's 128 rays and 8 steps."""
    clamp, exp2, coord = flags
    dev = cuda_device
    rng = np.random.default_rng(17)
    m = 3000
    valid = (np.arange(m) < 2900) & (np.arange(m) % 97 != 5)
    c = rng.normal(0, 0.4, (m, 3)).astype(np.float32)
    r = (np.log1p(np.exp(rng.normal(-3.5, 0.3, m))) + 0.01).astype(
        np.float32)
    c = np.where(valid[:, None], c, 1e15 if coord else 0.0).astype(
        np.float32)
    c_sq = np.where(valid, (c * c).sum(1), 1e30)[None].astype(np.float32)
    args = [tt(a).to(dev) for a in (
        inputs["ro"], inputs["rd"], inputs["t0"],
        np.ascontiguousarray(np.concatenate([c.T, r[None]])), c_sq,
        inputs["k"])]
    t_k, n_k = k5.variant_march(*args, STEPS, TILE, clamp, exp2, coord)
    _hold_to_float64_noise(args, STEPS, flags, t_k, n_k)

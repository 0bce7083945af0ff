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
The CUDA kernel is held against the plain version by the cuda-marked test
(run on a GPU: ``pytest -m cuda tests/test_torch_march_variants.py``); the
CPU test of the one-pass soft-min holds the arithmetic the kernel uses in
place of the two-pass row max.
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
from burn_raymarching_tpu_torch.ops.cuda import march_variants_kernel as k5
from burn_raymarching_tpu_torch.tools import exp_march_variants, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SIDE_W, N_SIDE_H, M, LIVE, STEPS, TILE, K = 16, 8, 16, 12, 8, 64, 18.5
FLAGS = [(c, e, x) for c in (False, True) for e in (False, True)
         for x in (False, True)]
IDS = ["+".join(name for name, on in zip(("clamp", "exp2", "coord"), flags)
              if on) or "base" for flags in FLAGS]
T_TOL = 1e-5
NORMAL_ATOL = 1e-3


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


def _online(val: torch.Tensor, clamp: bool, exp2: bool, k: float,
            lanes: int = 8) -> torch.Tensor:
    """csrc/march_variants.cu's mv_softmin in plain PyTorch, from the
    per-pair val [N, M]: ``lanes`` lanes stride over the slots; clamp sums
    exp(min(val, 80)); otherwise each lane keeps a running max and a sum
    relative to it, merged by the overall max."""
    ex = ((lambda x: torch.exp2(x * k5.LOG2E)) if exp2 else torch.exp)
    lg = ((lambda x: torch.log2(x) * k5.LN2) if exp2 else torch.log)
    n, m_cols = val.shape
    if clamp:
        total = ex(torch.clamp(val, max=80.0)).sum(1, keepdim=True)
        return lg(torch.clamp(total, min=1e-8)) / (-k)
    m = torch.full((n, lanes), -torch.inf, dtype=val.dtype)
    s = torch.zeros((n, lanes), dtype=val.dtype)
    for j in range(m_cols):
        lane, v = j % lanes, val[:, j]
        d = v - m[:, lane]
        e = ex(-d.abs())
        s[:, lane] = torch.where(d > 0, s[:, lane] * e + 1.0, s[:, lane] + e)
        m[:, lane] = torch.maximum(m[:, lane], v)
    mx = m.amax(dim=1, keepdim=True)
    total = torch.sum(s * ex(m - mx), dim=1, keepdim=True)
    return (lg(torch.clamp(total, min=1e-8)) + mx) / (-k)


@pytest.mark.parametrize("flags", FLAGS[:4] + FLAGS[4::2], ids=IDS[:4]
                         + IDS[4::2])
def test_one_pass_soft_min_matches_two_pass(inputs, flags):
    """The kernel's one-pass soft-min against the plain two-pass one, on
    points along the rays from the scene's inside to past it (float32
    rounding only: rtol 1e-5, atol 1e-6)."""
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
    val = torch.sqrt(torch.clamp(q, min=1e-6)) * (-K) + kr
    np.testing.assert_allclose(nn(_online(val, clamp, exp2, K)), nn(two),
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


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS, ids=IDS)
def test_cuda_kernel_matches_plain(inputs, cuda_device, flags):
    """K5 against its plain version on the card (one launch, counted), and
    bitwise equal at other tile sizes (a ray's arithmetic does not depend on
    its block)."""
    clamp, exp2, coord = flags
    dev = cuda_device
    args = [tt(a).to(dev) for a in _args(inputs, coord)]
    before = k5.variant_march.launches
    t_k, n_k = k5.variant_march(*args, STEPS, TILE, clamp, exp2, coord)
    assert k5.variant_march.launches == before + 1
    t_p, n_p = k5.variant_march_plain(*args, STEPS, TILE, clamp, exp2, coord)
    torch.cuda.synchronize()
    hit = nn(t_p)[:, 0] < 10.0
    np.testing.assert_allclose(nn(t_k)[hit], nn(t_p)[hit], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(nn(n_k)[hit], nn(n_p)[hit], atol=2e-3)
    for tile in (1, 32, 128):
        t_b, n_b = k5.variant_march(*args, STEPS, tile, clamp, exp2, coord)
        assert torch.equal(t_b, t_k) and torch.equal(n_b, n_k)

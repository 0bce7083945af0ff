"""K1: the port's march_shade against the JAX package's march_shade_pallas,
run in interpret mode as tests/test_pallas.py runs it.

On the CPU the port's wrapper runs its plain version (march + scene_normal).
t: rtol/atol 1e-5. Normals: atol 1e-4 (k = 32) to 1e-3 (k = 5) on rays
that hit (t < 10); the JAX kernel folds k*r into the soft-min, so the two
agree within a tolerance.
Missed rays' normals are finite differences of ~0 and carry no meaning.
The CUDA kernel itself is held against the plain version by the
cuda-marked tests (run on a GPU: ``pytest -m cuda tests/``). The CPU tests
of the packed table and of the one-pass soft-min hold the arithmetic the
kernel shares with K3 (csrc/common.cuh) in plain PyTorch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (cuda_device is a fixture)
    DANGO_CENTERS,
    DANGO_RADII,
    cuda_device,
    expanded_q,
    nn,
    soft_min_online,
    staged_q,
    tt,
)

from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.ops.pallas.march_shade_kernel import (
    march_shade_pallas,
)
from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
from burn_raymarching_tpu_torch.ops.sdf import soft_min
from burn_raymarching_tpu_torch.tools import kernel_cases as kc


@pytest.fixture(scope="module")
def rays():
    ro, rd = j_rays(16, 16, [0.0, 0.3, -1.2], [0.0, 0.0, 0.0], 50.0)
    return np.asarray(ro), np.asarray(rd)


def _jax(ro, rd, c, r, k, **kw):
    t, n = march_shade_pallas(jnp.asarray(ro), jnp.asarray(rd),
                              jnp.asarray(c), jnp.asarray(r), k,
                              interpret=True, tile_n=64, **kw)
    return np.asarray(t), np.asarray(n)


def _check(got, want, normal_atol=1e-4):
    (t_g, n_g), (t_w, n_w) = got, want
    np.testing.assert_allclose(nn(t_g), t_w, rtol=1e-5, atol=1e-5)
    hit = t_w[:, 0] < 10.0
    assert hit.sum() > 20
    np.testing.assert_allclose(nn(n_g)[hit], n_w[hit], atol=normal_atol)


# The 1/(2 eps) central difference magnifies the k*r fold's rounding; the
# lower k, the more spheres blend. Worst seen: 4.5e-4 at k = 5, 1.5e-4 at
# k = 18.5 (tests/test_pallas.py holds the JAX kernel to its own XLA twin
# at 2e-4).
@pytest.mark.parametrize("k,normal_atol", [(5.0, 1e-3), (18.5, 2e-4),
                                           (32.0, 1e-4)])
def test_cold_matches_jax_kernel(rays, k, normal_atol):
    ro, rd = rays
    want = _jax(ro, rd, DANGO_CENTERS, DANGO_RADII, k)
    got = k1.march_shade(tt(ro), tt(rd), tt(DANGO_CENTERS), tt(DANGO_RADII),
                         k)
    _check(got, want, normal_atol)


def test_warm_start_t_init_matches_jax_kernel(rays):
    ro, rd = rays
    t_cold, _ = _jax(ro, rd, DANGO_CENTERS, DANGO_RADII, 18.5)
    t0 = (0.8 * t_cold).astype(np.float32)
    want = _jax(ro, rd, DANGO_CENTERS, DANGO_RADII, 18.5, num_steps=16,
                t_init=jnp.asarray(t0))
    got = k1.march_shade(tt(ro), tt(rd), tt(DANGO_CENTERS), tt(DANGO_RADII),
                         18.5, num_steps=16, t_init=tt(t0))
    _check(got, want, normal_atol=2e-4)


def test_masked_padding_matches_jax_kernel(rays):
    ro, rd = rays
    c = np.concatenate([DANGO_CENTERS, np.full((3, 3), 0.1, np.float32)])
    r = np.concatenate([DANGO_RADII, np.full((3, 1), 0.5, np.float32)])
    mask = np.arange(6) < 3
    want = _jax(ro, rd, c, r, 32.0, mask=jnp.asarray(mask))
    got = k1.march_shade(tt(ro), tt(rd), tt(c), tt(r), 32.0, mask=tt(mask))
    _check(got, want)
    # And the masked table equals the unpadded one.
    plain = k1.march_shade(tt(ro), tt(rd), tt(DANGO_CENTERS),
                           tt(DANGO_RADII), 32.0)
    np.testing.assert_allclose(nn(got[0]), nn(plain[0]), rtol=1e-6,
                               atol=1e-6)


def test_march_table_layout():
    c = tt(DANGO_CENTERS)
    r = tt(DANGO_RADII)
    mask = torch.tensor([True, False, True])
    table = k1.march_table(c, r, mask, 18.5)
    assert table.shape == (3, 5) and table.is_contiguous()
    np.testing.assert_array_equal(nn(table[:, :3]), DANGO_CENTERS)
    np.testing.assert_array_equal(nn(table[:, 4]),
                                  DANGO_RADII[:, 0] * np.float32(18.5))
    assert table[1, 3].item() == pytest.approx(1e30)
    assert table[0, 3].item() == pytest.approx(0.09)
    # On the CPU the wrapper of the pack kernel is the plain version.
    assert torch.equal(k1.pack_march_table(c, r, mask, 18.5), table)


def _random_table(seed, m, live, k=18.5):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 0.4, (m, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.3, (m, 1)).astype(np.float32)
    mask = np.arange(m) < live
    return c, r, mask, k1.march_table(tt(c), tt(r), tt(mask), k)


@pytest.mark.parametrize("m,live", [(1, 1), (8, 7), (33, 20), (128, 100)])
def test_march_table_unpacks(m, live):
    """Unpacking gives back the centers, r*k and |c|^2; masked slots carry
    1e30 and nothing else of the slot changes."""
    c, r, mask, table = _random_table(3, m, live, k=32.0)
    np.testing.assert_array_equal(nn(table[:, :3]), c)
    np.testing.assert_array_equal(nn(table[:, 4]), r[:, 0] * np.float32(32.0))
    c_sq = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2]
    np.testing.assert_array_equal(nn(table[:live, 3]), c_sq[:live])
    np.testing.assert_array_equal(nn(table[live:, 3]),
                                  np.full(m - live, 1e30, np.float32))
    no_mask = k1.march_table(tt(c), tt(r), None, 32.0)
    np.testing.assert_array_equal(nn(no_mask[:, 3]), c_sq)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staged_q_bitwise_equals_expanded(seed):
    """Folding the -2 into the staged centers is exact: q is bitwise the
    expanded form's, masked slots included."""
    _, _, _, table = _random_table(seed, 64, 50)
    rng = np.random.default_rng(100 + seed)
    p = tt(rng.normal(0, 1.5, (4096, 3)).astype(np.float32))
    got, want = staged_q(p, table), expanded_q(p, table)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert bool((got[:, 50:] > 1e29).all())


@pytest.mark.parametrize("k,lanes", [(5.0, 1), (18.5, 4), (32.0, 8),
                                     (128.0, 32)])
def test_online_soft_min_matches_two_pass(k, lanes):
    """The kernels' one-pass soft-min against ops/sdf.soft_min, 1e-6
    relative (plus 1e-7 for distances near 0), with masked slots and with a
    far point at distance ~50, where dropping the max would underflow every
    term at k = 128 and return the 1e-8 clamp instead of the distance."""
    rng = np.random.default_rng(int(k))
    c, r, mask, table = _random_table(11, 40, 33, k=k)
    p = rng.normal(0, 0.6, (257, 3)).astype(np.float32)
    p[0] = [50.0, 0.0, 0.0]
    dists = torch.sqrt(torch.clamp(staged_q(tt(p), table), min=1e-6)) \
        - tt(r)[:, 0]
    want = soft_min(dists, k, mask=tt(mask))
    got = soft_min_online(dists, k, lanes=lanes)
    np.testing.assert_allclose(nn(got), nn(want), rtol=1e-6, atol=1e-7)
    assert 48.0 < got[0].item() < 50.0
    # Skipping the exp of far columns would change no bit of the sum.
    assert torch.equal(got, soft_min_online(dists, k, lanes=lanes,
                                            skip_below=40.0))


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_cuda_kernel_matches_plain(rays, cuda_device, warm):
    dev = cuda_device
    ro, rd = (tt(x).to(dev) for x in rays)
    c = torch.cat([tt(DANGO_CENTERS), torch.full((5, 3), 0.1)]).to(dev)
    r = torch.cat([tt(DANGO_RADII), torch.full((5, 1), 0.5)]).to(dev)
    mask = (torch.arange(8) < 3).to(dev)
    kw = {}
    if warm:
        t_cold, _ = k1.march_shade_plain(ro, rd, c, r, 18.5, mask=mask)
        kw = dict(num_steps=16, t_init=(0.8 * t_cold).contiguous())
    before = k1.march_shade.launches
    t_k, n_k = k1.march_shade(ro, rd, c, r, 18.5, mask=mask, **kw)
    assert k1.march_shade.launches == before + 1
    t_p, n_p = k1.march_shade_plain(ro, rd, c, r, 18.5, mask=mask, **kw)
    torch.cuda.synchronize()
    hit = t_p[:, 0] < 10.0
    np.testing.assert_allclose(nn(t_k), nn(t_p), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nn(n_k)[nn(hit)], nn(n_p)[nn(hit)],
                               atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,live,side", [
    (1, 1, 64), (7, 7, 32), (8, 7, 128), (16, 12, 32), (32, 25, 256),
    (33, 20, 32), (128, 100, 128), (1500, 1200, 32)])
def test_cuda_kernel_table_widths(cuda_device, m, live, side):
    """Table widths from 1 to 1,500 slots at side x side rays, which take
    every lanes-per-ray instantiation (1, 8, 4, 16, 2, 32, 8, 32 lanes) and,
    at M = 1,500, the chunked path; cold, against the plain version; the
    pack kernel's table bitwise against the plain table. Each gap is held
    to K1's fixed tolerance (kernel_cases.MARCH_TOLS) or, where the march
    itself is noisier (among 16,384+ rays some graze a sphere), to 5x the
    plain version's own gap to the same march in float64, plus 1e-5."""
    dev = cuda_device
    c, r, mask, table = _random_table(5, m, live)
    c[:live] *= 0.6
    if m > 8:
        r = r * 0.3             # many spheres: small ones
    c, r, mask = tt(c).to(dev), tt(r).to(dev), tt(mask).to(dev)
    before = k1.pack_march_table.launches
    packed = k1.pack_march_table(c, r, mask, 18.5)
    assert k1.pack_march_table.launches == before + 1
    assert torch.equal(packed, k1.march_table(c, r, mask, 18.5))
    ro, rd = (tt(x).to(dev) for x in
              j_rays(side, side, [0.0, 0.3, -1.6], [0.0, 0.0, 0.0], 50.0))
    t_k, n_k = k1.march_shade(ro, rd, c, r, 18.5, mask=mask)
    t_p, n_p = k1.march_shade_plain(ro, rd, c, r, 18.5, mask=mask)
    t_64, n_64 = k1.march_shade_plain(ro.double(), rd.double(), c.double(),
                                      r.double(), 18.5, mask=mask)
    torch.cuda.synchronize()
    hit = t_64[:, 0] < 10.0
    assert int(hit.sum()) > 20

    def gaps(t_a, n_a, t_b, n_b):
        dt = (t_a.double() - t_b.double()).abs()[:, 0]
        return (dt[hit].max().item(),
                (dt / (1.0 + t_b.double()[:, 0].abs())).max().item(),
                (n_a.double() - n_b.double())[hit].abs().max().item())

    noise = gaps(t_p, n_p, t_64, n_64)
    for gap, fixed, own in zip(gaps(t_k, n_k, t_p, n_p), (1e-2, 2e-3, 5e-3),
                               noise):
        assert gap <= max(fixed, 5.0 * own + 1e-5), (gap, noise)


@pytest.mark.cuda
def test_cuda_kernel_chunked_table(cuda_device):
    """M above the kernel's 1,024-slot shared-memory chunk: the table is
    staged chunk by chunk (the path config 1 never reaches)."""
    dev = cuda_device
    rng = np.random.default_rng(13)
    m, live = 1500, 1200
    c = torch.as_tensor(rng.normal(0, 0.4, (m, 3)), dtype=torch.float32,
                        device=dev)
    r = torch.as_tensor(rng.uniform(0.01, 0.05, (m, 1)), dtype=torch.float32,
                        device=dev)
    mask = (torch.arange(m) < live).to(dev)
    ro, rd = (tt(x).to(dev) for x in
              j_rays(16, 16, [0.0, 0.3, -1.5], [0.0, 0.0, 0.0], 50.0))
    t_k, n_k = k1.march_shade(ro, rd, c, r, 32.0, mask=mask)
    t_p, n_p = k1.march_shade_plain(ro, rd, c, r, 32.0, mask=mask)
    hit = nn(t_p[:, 0] < 10.0)
    assert hit.sum() > 20
    # t: K1's fixed tolerances (ill-conditioned rays). Normals: near
    # the surface of r ~ 0.03 spheres the expanded form |p|^2+|c|^2-2p.c
    # cancels, so the SDF carries ~6e-7 rounding that the 1/(2 eps) central
    # difference lifts to ~1e-3..5e-3 (5.2e-3 seen on an H100).
    np.testing.assert_allclose(nn(t_k)[hit], nn(t_p)[hit], atol=1e-2)
    dt = np.abs(nn(t_k) - nn(t_p))[:, 0] / (1.0 + np.abs(nn(t_p)[:, 0]))
    assert dt.max() <= 2e-3
    np.testing.assert_allclose(nn(n_k)[hit], nn(n_p)[hit], atol=1e-2)

    # Trailing masked slots, bitwise: a 2,048-slot table whose last 1,048
    # slots are masked must give exactly the 1,000-slot result (the kernel
    # visits only the columns up to the last live one; masked slots would
    # add exp(-1e16) = 0 and never win the max). Junk staged from the
    # masked columns would bring live spheres back.
    junk = torch.full((2048 - 1000, 3), 0.05, device=dev)
    c2 = torch.cat([c[:1000], junk])
    r2 = torch.cat([r[:1000], torch.full((2048 - 1000, 1), 0.3, device=dev)])
    mask2 = (torch.arange(2048) < 1000).to(dev)
    t_a, n_a = k1.march_shade(ro, rd, c2, r2, 32.0, mask=mask2)
    t_b, n_b = k1.march_shade(ro, rd, c[:1000].contiguous(),
                              r[:1000].contiguous(), 32.0)
    assert torch.equal(t_a, t_b) and torch.equal(n_a, n_b)


@pytest.mark.cuda
@pytest.mark.parametrize("live,slots",
                         [*kc.K1_NARROW, (kc.M_LIVE, kc.M_SLOTS)])
def test_cuda_kernel_at_the_main_path_inputs(cuda_device, live, slots):
    """K1 on config 1's main-path inputs (kernel_cases.main_path_inputs:
    16,384 rays of the dango rig, ``live`` random primitives in ``slots``
    slots) against its plain version: at 128 slots cold and warm (16 steps
    from 0.8 of the plain cold t) within the fixed MARCH_TOLS; at the
    narrower tables config 1 trains at, cold, within the larger of those and
    5x the plain version's own gap to float64 plus 1e-5."""
    dev = cuda_device
    ro, rd, padded, mask, activate, _ = kc.main_path_inputs(dev, live,
                                                             slots)
    with torch.no_grad():
        c, _, r, _, _ = activate(padded)
    args = (ro, rd, c, r, kc.K1_K)
    t_p, n_p = k1.march_shade_plain(*args, mask=mask)
    tols = dict(kc.MARCH_TOLS)
    runs = [dict(mask=mask)]
    if slots == kc.M_SLOTS:
        runs.append(dict(mask=mask, num_steps=16,
                         t_init=(t_p * 0.8).contiguous()))
    else:
        t_64, n_64 = k1.march_shade_plain(ro.double(), rd.double(),
                                          c.double(), r.double(), kc.K1_K,
                                          mask=mask)
        noise = kc.march_noise_tols(t_p, n_p, t_64, n_64)
        tols = {key: max(tol, noise[key]) for key, tol in tols.items()}
    for kw in runs:
        errs = kc.march_errors(*k1.march_shade(*args, **kw),
                               *k1.march_shade_plain(*args, **kw))
        assert not kc.march_excess(errs, tols), (kw.keys(), errs, tols)

"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port, so the two see identical arrays. Tests that need a GPU take
the ``cuda_device`` fixture, which decides at run time (never at import)
and skips without a card.
"""

from __future__ import annotations

import os

# libkineto keeps CUPTI set up from a process's first torch.profiler session
# to its end; on an H100 a session that starts minutes later then loses the
# device events at the start of its window (the card tests that read a
# trace lost the first replay's kernels when run after the other card
# tests, and passed alone). With TEARDOWN_CUPTI=1 libkineto finalizes CUPTI
# after every trace, so each profiler session starts from a fresh CUPTI.
# libkineto reads the variable at run time (torch's profiler itself sets it
# during a session), so setting it here, when the test modules are
# collected and before any test starts a profiler, is enough.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

# Tier-1 runs several pytest workers; keep torch's intra-op pool small.
torch.set_num_threads(2)

DANGO_CENTERS = np.asarray([[-0.3, 0.0, 0.0], [0.0, 0.0, 0.0],
                            [0.3, 0.0, 0.0]], np.float32)
DANGO_COLORS = np.eye(3, dtype=np.float32)
DANGO_RADII = np.asarray([[0.2], [0.15], [0.2]], np.float32)


def tt(x, **kw) -> torch.Tensor:
    """numpy / JAX array → torch tensor (CPU)."""
    return torch.as_tensor(np.array(x), **kw)


def nn(x) -> np.ndarray:
    """torch tensor / JAX array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def random_raw_params(seed: int, m: int) -> dict:
    """Raw SceneParams arrays (numpy) with the checkpoint keys."""
    rng = np.random.default_rng(seed)
    return {
        "centers": rng.normal(0, 0.3, (m, 3)).astype(np.float32),
        "colors": rng.normal(0, 1.5, (m, 3)).astype(np.float32),
        "radii": rng.normal(-1.0, 0.5, (m, 1)).astype(np.float32),
        "light_dir": np.asarray([0.3, 1.0, -0.4], np.float32),
        "ambient": np.asarray([-1.0], np.float32),
    }


def jax_params(d: dict):
    import jax.numpy as jnp

    from burn_raymarching_tpu.models.scene import SceneParams

    return SceneParams(**{k: jnp.asarray(v) for k, v in d.items()})


def pad_raw(d: dict, pad: int) -> dict:
    """Append ``pad`` zero primitive rows."""
    out = dict(d)
    for k in ("centers", "colors", "radii"):
        out[k] = np.concatenate([d[k], np.zeros((pad, d[k].shape[1]),
                                                np.float32)])
    return out


def staged_q(p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., N, M] as the march kernels form them from a
    staged table ([M, 5], or [B, M, 5] with p [B, N, 3]; rows cx, cy, cz,
    |c|², r): the center scaled by −2, then
    (|p|² + |c|²) + (px·cx' + (py·cy' + pz·cz'))."""
    px, py, pz = (p[..., i, None] for i in range(3))
    cx, cy, cz = (-2.0 * table[..., None, :, i] for i in range(3))
    p_sq = (px * px + py * py) + pz * pz
    return (p_sq + table[..., None, :, 3]) + (px * cx + (py * cy + pz * cz))


def expanded_q(p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The same distances in the expanded form the kernels used before the
    −2 was folded into the table: (|p|² + |c|²) − 2 (px·cx + (py·cy +
    pz·cz))."""
    px, py, pz = (p[..., i, None] for i in range(3))
    cx, cy, cz = (table[..., None, :, i] for i in range(3))
    p_sq = (px * px + py * py) + pz * pz
    return (p_sq + table[..., None, :, 3]) - 2.0 * (px * cx
                                                    + (py * cy + pz * cz))


def soft_min_online(dists: torch.Tensor, k: float, lanes: int = 4,
                    skip_below: float = float("inf")) -> torch.Tensor:
    """The march kernels' one-pass soft-min of ``dists`` [N, M] → [N, 1], in
    plain PyTorch: ``lanes`` lanes stride over the columns, each keeping a
    running max m and a sum s relative to it (a column with d = v − m adds
    e = exp(−|d|) as s + e, or as s·e + 1 when it raises the max), then the
    lanes merge by the overall max. ``skip_below`` sets e = 0 where
    |d| >= it, which the kernels do not do: at 40 it must change no bit."""
    val = dists * (-k)
    n, m_cols = val.shape
    m = torch.full((n, lanes), -torch.inf, dtype=val.dtype)
    s = torch.zeros((n, lanes), dtype=val.dtype)
    for j in range(m_cols):
        lane, v = j % lanes, val[:, j]
        d = v - m[:, lane]
        e = torch.where(d.abs() < skip_below, torch.exp(-d.abs()),
                        torch.zeros_like(d))
        s[:, lane] = torch.where(d > 0, s[:, lane] * e + 1.0, s[:, lane] + e)
        m[:, lane] = torch.maximum(m[:, lane], v)
    mx = m.amax(dim=1, keepdim=True)
    total = torch.sum(s * torch.exp(m - mx), dim=1, keepdim=True)
    return (torch.log(torch.clamp(total, min=1e-8)) + mx) / (-k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# Config 4's knot capture: views at size², GT spheres.
C4_SET = dict(views=30, size=512, gt_n=400)
_C4_KNOT_SET: list[str] = []


@pytest.fixture(scope="session")
def c4_knot_set(tmp_path_factory):
    """Config 4's knot capture (C4_SET), written by the port's generator on
    the card once a process: each module that imports this fixture gets a
    fixture of its own from pytest, so the first one keeps the path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    if not _C4_KNOT_SET:
        from burn_raymarching_tpu_torch.tools import generate, run_c5

        data = str(tmp_path_factory.mktemp("c4_card") / "data")
        generate.main(run_c5.generate_argv(data, **C4_SET))
        _C4_KNOT_SET.append(data)
    return _C4_KNOT_SET[0]


def _table_dists(p: torch.Tensor, table: torch.Tensor, n: int):
    """[N, n] surface distances of points p against the first n columns of a
    K2 table (shade_kernel.shade_table), in the kernels' expanded form, and
    the unclamped squared distances."""
    cq, r = table[:n, :4], table[table.shape[0] // 2 - 1:, 0][:n]
    px, py, pz = (p[:, i, None] for i in range(3))
    p_sq = (px * px + py * py) + pz * pz
    q = (p_sq + cq[None, :, 3]) - 2.0 * (
        px * cq[None, :, 0] + (py * cq[None, :, 1] + pz * cq[None, :, 2]))
    return torch.sqrt(torch.clamp(q, min=1e-6)) - r[None, :], q


def _shade_table_parts(table: torch.Tensor):
    m = table.shape[0] // 2 - 1
    return (m, int(table[2 * m + 1, 1]), table[m:2 * m, 1:4],
            table[2 * m, :3], table[2 * m, 3], table[2 * m + 1, 0])


def shade_online(ro, rd, t, normal, table, k: float, lanes: int = 4
                 ) -> torch.Tensor:
    """The K2 forward kernel's arithmetic in plain PyTorch → [N, 3]: only
    the table's live columns are visited; ``lanes`` lanes stride over them,
    each with a running minimum distance dm and sums relative to it (a
    column at delta = d − dm adds e = exp(−c·|delta|) as s + e, or as
    s·e + 1 when it lowers the minimum, the colour sums rescaled like s10);
    the lanes merge by the overall minimum. One pass at p0, one at p."""
    m, n, colors, lhat, amb, _ = _shade_table_parts(table)
    inf = torch.tensor(torch.inf, dtype=ro.dtype)

    def one_pass(p, rates, with_colors):
        d_all, _ = _table_dists(p, table, n)
        rows = p.shape[0]
        dm = inf.expand(rows, lanes).clone()
        sums = [torch.zeros((rows, lanes), dtype=ro.dtype) for _ in rates]
        cols = torch.zeros((rows, lanes, 3), dtype=ro.dtype)
        for j in range(n):
            lane, d = j % lanes, d_all[:, j]
            delta = d - dm[:, lane]
            lower = delta < 0
            for which, (s, rate) in enumerate(zip(sums, rates)):
                e = torch.exp(-rate * delta.abs())
                a, b = torch.where(lower, e, 1.0), torch.where(lower, 1.0, e)
                s[:, lane] = s[:, lane] * a + b
                if with_colors and which == 0:
                    cols[:, lane] = (cols[:, lane] * a[:, None]
                                     + b[:, None] * colors[j][None, :])
            dm[:, lane] = torch.minimum(dm[:, lane], d)
        dmin = dm.amin(dim=1, keepdim=True)
        totals = []
        for which, (s, rate) in enumerate(zip(sums, rates)):
            scale = torch.exp(-rate * (dm - dmin))
            totals.append(torch.sum(s * scale, dim=1, keepdim=True))
            if with_colors and which == 0:
                cols = torch.sum(cols * scale[:, :, None], dim=1)
        return dmin, totals, cols

    def softmin(dmin, s):
        return (torch.log(torch.clamp(s, min=1e-8)) + dmin * (-k)) / (-k)

    dmin0, (s0,), _ = one_pass(ro + rd * t, (k,), False)
    p = ro + rd * (t + softmin(dmin0, s0))
    dmin, (s10, sk), csum = one_pass(p, (10.0, k), True)
    dot = torch.sum(normal * lhat[None, :], dim=1, keepdim=True)
    lighting = amb + torch.clamp(dot, min=0.0) * (1.0 - amb)
    cov = 1.0 / (1.0 + torch.exp(softmin(dmin, sk) * 15.0))
    return (csum / s10) * lighting * cov


def shade_backward_model(ro, rd, t, normal, table, k: float, g):
    """The K2 backward kernel's arithmetic in plain PyTorch → (d_centers
    [M,3], d_radii [M], d_colors [M,3], d_light [3], d_ambient [1]): the
    forward recomputed relative to the row minima, wsum taken as dmix·mix
    (no pass over the columns), pass B at p, pass C at p0, and the l̂ → light
    projection folded in. Columns past the live count get exactly 0."""
    m, n, colors_all, lhat, amb, l_norm = _shade_table_parts(table)
    colors, centers = colors_all[:n], table[:n, :3]

    def weights(p, rate):
        d, q = _table_dists(p, table, n)
        e = torch.exp(-rate * (d - d.amin(dim=1, keepdim=True)))
        return d, q, e, torch.sum(e, dim=1, keepdim=True)

    p0 = ro + rd * t
    d0, q0, e0, s0 = weights(p0, k)
    s0 = torch.clamp(s0, min=1e-8)
    dmin0 = d0.amin(dim=1, keepdim=True)
    p = ro + rd * (t + (torch.log(s0) + dmin0 * (-k)) / (-k))
    d, q, e10, s10 = weights(p, 10.0)
    _, _, ek, sk = weights(p, k)
    sk = torch.clamp(sk, min=1e-8)
    mix = (e10 @ colors) / s10
    dist_scene = (torch.log(sk) + d.amin(dim=1, keepdim=True) * (-k)) / (-k)
    cov = 1.0 / (1.0 + torch.exp(dist_scene * 15.0))
    dot = torch.sum(normal * lhat[None, :], dim=1, keepdim=True)
    diff = torch.clamp(dot, min=0.0)
    lighting = amb + diff * (1.0 - amb)

    g_dot_mix = torch.sum(g * mix, dim=1, keepdim=True)
    d_mix = g * lighting * cov
    d_light_scalar = g_dot_mix * cov
    d_cov = g_dot_mix * lighting
    d_amb = torch.sum(d_light_scalar * (1.0 - diff)).reshape(1)
    d_dot = torch.where(dot > 0, d_light_scalar * (1.0 - amb), 0.0)
    d_lhat = torch.sum(d_dot * normal, dim=0)
    d_light = (d_lhat - lhat * torch.sum(lhat * d_lhat)) / l_norm

    wsum = torch.sum(d_mix * mix, dim=1, keepdim=True)
    d_ds = d_cov * (-15.0) * cov * (1.0 - cov)
    w, v = e10 / s10, ek / sk
    d_D = -10.0 * w * (d_mix @ colors.T - wsum) + d_ds * v
    dq = torch.where(q > 1e-6, d_D * 0.5
                     / torch.sqrt(torch.clamp(q, min=1e-6)), 0.0)
    d_c = 2.0 * (centers * dq.sum(0)[:, None] - dq.T @ p)
    d_r = -d_D.sum(0)
    d_col = w.T @ d_mix
    d_p = 2.0 * (p * dq.sum(1, keepdim=True) - dq @ centers)
    dd0 = torch.sum(rd * d_p, dim=1, keepdim=True) * (e0 / s0)
    dq0 = torch.where(q0 > 1e-6, dd0 * 0.5
                      / torch.sqrt(torch.clamp(q0, min=1e-6)), 0.0)
    d_c = d_c + 2.0 * (centers * dq0.sum(0)[:, None] - dq0.T @ p0)
    d_r = d_r - dd0.sum(0)

    def pad(x):
        out = torch.zeros((m, *x.shape[1:]), dtype=x.dtype)
        out[:n] = x
        return out

    return pad(d_c), pad(d_r), pad(d_col), d_light, d_amb


def repulsion_sum_sliced(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                         include_far: bool, slices: int) -> torch.Tensor:
    """The K4 kernels' decomposition in plain PyTorch: each cluster's
    columns (its neighbors' members, then with ``include_far`` every
    centroid, which carries the cluster's far weight and matches no member
    id) are cut into ``slices`` equal slices and the slices' sums are added
    in slice order."""
    c_count, wg = nb_w.shape
    col_xyz, col_w, col_id = nb_cs, nb_w, nbm
    if include_far:
        ca = cents.shape[1]
        col_xyz = torch.cat([nb_cs, cents[:, None, :].expand(3, c_count, ca)],
                            dim=2)
        col_w = torch.cat([nb_w, far_w], dim=1)
        col_id = torch.cat([nbm, torch.full((c_count, ca), -1,
                                            dtype=nbm.dtype)], dim=1)
    cols = col_w.shape[1]
    slice_cols = -(-cols // min(slices, cols))
    total = torch.zeros((), dtype=cs.dtype)
    for lo in range(0, cols, slice_cols):
        sl = slice(lo, min(lo + slice_cols, cols))
        d2 = sum((cs[x][:, :, None] - col_xyz[x][:, None, sl]) ** 2
                 for x in range(3))
        extra = (mi[:, :, None] == col_id[:, None, sl]).to(cs.dtype) * 100.0
        total = total + torch.sum(
            (w[:, :, None] * col_w[:, None, sl])
            / (torch.sqrt(torch.clamp(d2, min=1e-6)) + extra + 1e-6))
    return total


# --- the quality recipe: a tiny knot capture and refine noise for both ---- #

KNOT_FLAGS = ["--init-layout", "cloud", "--init-n", "120", "--turbo",
              "--cull", "32", "--sample-mode", "tile", "--cluster-repulsion",
              "--wd-mode", "decoupled", "--lr", "0.02",
              "--lr-scales", "0.001,1,0.1,0.5", "--smooth-k", "128",
              "--sharp", "40,60", "--merge-cell", "0.04"]


def tiny_knot_dataset(out_dir: str, *extra_flags, views: int = 2,
                      size: int = 32, cull_tile: int = 64,
                      cull_budget: int = 64, batch: int = 256, **cfg_kw):
    """The tiny knot capture for both packages → (cfg, arrays, port dataset,
    JAX dataset).

    The port's generator writes ``views`` images at ``size``² into
    ``out_dir`` (once); ``cfg`` is the large-scene recipe cut to that size
    (the port's TrainConfig is a field-for-field copy of the JAX package's,
    which reads it by attribute, so one object serves both); ``arrays`` are the Morton-ordered (rays_o, rays_d, targets)
    as numpy, and both datasets are built from those same arrays."""
    import dataclasses
    import os

    from burn_raymarching_tpu.config import TrainConfig
    from burn_raymarching_tpu.data.dataset import RayDataset as JaxDataset
    from burn_raymarching_tpu_torch.data.dataset import RayDataset
    from burn_raymarching_tpu_torch.tools import generate, train_cli
    from burn_raymarching_tpu_torch.train.loop import build_dataset

    if not os.path.exists(os.path.join(out_dir, "cameras.json")):
        generate.main(["--out", out_dir, "--size", str(size), "--views",
                       str(views), "--scene", "knot", "--gt-k", "128",
                       "--gt-sharp", "40", "--device", "cpu"])
    port_cfg = train_cli.build_config(train_cli.make_parser().parse_args(
        ["--cameras", os.path.join(out_dir, "cameras.json"),
         "--width", str(size), "--height", str(size), "--batch", str(batch),
         "--init-points", os.path.join(out_dir, "points.json"),
         "--no-pallas", "--checkpoint-dir", "", *KNOT_FLAGS, *extra_flags]))
    port_cfg = dataclasses.replace(port_cfg, cull_tile=cull_tile,
                                   cull_budget=cull_budget,
                                   cull_cluster_group=8, **cfg_kw)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    assert fields == {f.name for f in dataclasses.fields(port_cfg)}
    ds = build_dataset(port_cfg, device="cpu")
    arrays = tuple(nn(x).copy() for x in (ds.rays_o, ds.rays_d, ds.targets))
    ds = RayDataset(*arrays, fg_threshold=port_cfg.fg_pixel_threshold,
                    device="cpu")
    ds_j = JaxDataset(*arrays, fg_threshold=port_cfg.fg_pixel_threshold)
    return port_cfg, arrays, ds, ds_j


def knot_params(cfg, m_pad: int = 128, seed: int = 0,
                raw_radius: float = -3.0) -> tuple[dict, np.ndarray]:
    """A prior-seeded cloud on the knot with random colours and radii
    (physical radius ~softplus(``raw_radius``) + 0.01: 0.06 by default) →
    (raw padded arrays with the checkpoint keys, mask [m_pad])."""
    import json

    with open(cfg.init_points) as f:
        pts = np.asarray(json.load(f)["points"], np.float32).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    n = cfg.init_n
    raw = {
        "centers": (pts[rng.integers(0, pts.shape[0], n)]
                    + rng.normal(0, 0.02, (n, 3))).astype(np.float32),
        "colors": rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        "radii": rng.normal(raw_radius, 0.3, (n, 1)).astype(np.float32),
        "light_dir": np.asarray([-0.4, 0.6, -1.0], np.float32),
        "ambient": np.asarray([-1.5], np.float32),
    }
    return pad_raw(raw, m_pad - n), np.arange(m_pad) < n


def jax_refine_draws(key, m_pad: int, n_chunks: int, light: bool = False):
    """The noise the JAX package's refine chains draw, for injection into
    the port's ``draws`` hook → draws(chunk_index, i).

    Replays train/refine.py's key handling: one ``jax.random.split`` of the
    running key per chunk; proposal ``i`` of a chunk folds ``i`` into the
    chunk's key and splits it in four (selection uniforms, centre, radius
    and colour normals; the Metropolis uniform comes from a further fold
    with 0x7e39), or in two for ``light_refine`` (light_dir, ambient)."""
    import jax

    subs = []
    for _ in range(n_chunks):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draws(chunk_index, i):
        kk = jax.random.fold_in(subs[chunk_index], i)
        if light:
            k1, k2 = jax.random.split(kk)
            return (np.array(jax.random.normal(k1, (3,))),
                    np.array(jax.random.normal(k2, (1,))))
        k1, k2, k3, k4 = jax.random.split(kk, 4)
        return (np.array(jax.random.uniform(k1, (m_pad, 1))),
                np.array(jax.random.normal(k2, (m_pad, 3))),
                np.array(jax.random.normal(k3, (m_pad, 1))),
                np.array(jax.random.normal(k4, (m_pad, 3))),
                np.array(jax.random.uniform(
                    jax.random.fold_in(kk, 0x7e39), ())))

    return draws


def jax_culled_march(*args, t_init=None, **kw):
    """The JAX package's plain culled march behind the port's K3 signature
    (torch tensors in and out). At k = 128 around spheres of radius ~0.03
    two float32 marches differ by ~3e-3 in the normals, so a test of what
    surrounds the march hands both packages this one."""
    import jax.numpy as jnp

    from burn_raymarching_tpu.render.culled import culled_march_normals_xla

    t, n = culled_march_normals_xla(
        *(jnp.asarray(nn(a)) if torch.is_tensor(a) else a for a in args),
        t_init=None if t_init is None else jnp.asarray(nn(t_init)), **kw)
    return torch.tensor(np.asarray(t)), torch.tensor(np.asarray(n))

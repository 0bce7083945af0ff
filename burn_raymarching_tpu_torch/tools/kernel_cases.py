"""The kernel cases: the inputs, checks and timers that the port's kernel
tests (``tests/test_torch_*.py``) and the on-card kernel timer
(``tools/bench_kernels.py``) share.

Inputs at the main paths' shapes: 16,384 rays of config 1's dango rig
against a random table (``main_path_inputs``); config 4's knot-seeded cloud
(``knot_cloud``), its Morton ray tiles with their top-K tables
(``c4_tiles``), K3's chunked path (``chunked_tiles``), tables with every
slot valid (``full_tables``) and K6's inputs on them (``k6_inputs``); the
dry run's K3 tables (``dryrun_k3_inputs``). Checks: a march against its
plain version (``march_errors``), held to fixed tolerances (``MARCH_TOLS``)
or to 5x the plain version's own float32 gap to the same march in float64
(``march_noise_tols``), the keys outside them (``march_excess``); both
versions' gaps to float64 (``float64_gaps``); the culled tail with its
gradients (``k6_run``); a selection against the plain one on its own cones
(``k7_compare``); two frames as the viewer writes them (``u8_gaps``).
Timers: ``time_ms`` (the call between CUDA events), ``graph_ms`` (the call
replayed from a CUDA graph, without the host's launch work) and ``bound``,
the least time the card could take.

Nothing of the package is imported at module level: every function imports
what it needs when it runs. ``bench_kernels.py --root OLD_TREE`` loads this
file by its path after putting the older tree first on ``sys.path``, so
that this tree's cases drive the older tree's wrappers.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

# Config 1's main path: 16,384 rays, 100 live primitives in 128 slots, the
# last stage's soft-min sharpness; the narrower tables config 1 trains at
# (live, slots), and K2's second shape, what the config-1 step runs after a
# short training.
N_RAYS = 16384
M_LIVE, M_SLOTS = 100, 128
K1_K = 18.5
K1_NARROW = ((7, 8), (25, 32))
K2_NARROW = (10, 16)
# Config 4 (runs/c4_r2): the knot capture (views at size², GT spheres), the
# prior-seeded init, the ray tiles a step marches, the per-tile top-K
# budget and the soft-min sharpness.
C4_VIEWS, C4_SIZE, C4_GT_N, C4_INIT_N = 30, 512, 400, 5120
C4_TILES, C4_TILE, C4_BUDGET, C4_K = 32, 512, 2048, 128.0
# Config 4's compositor: softmax and coverage sharpness.
C4_SHARPNESS = (40.0, 60.0)
# M = 51,200: scripts/bench_large.py's primitive count (C = 800 clusters).
LARGE_INIT_N = 51200
# K3's chunked path: tiles x live columns (the resident table holds 4,096).
CHUNKED_TILES, CHUNKED_K = 8, 8192

# A march against its plain version. The march is ill-conditioned on some
# rays (on config 1's inputs the plain march in float32 differs from
# float64 by up to 4e-3 in t on hit rays, 4e-4 relative on missed rays and
# 1.3e-3 in the normal), so t is held to |dt| <= 1e-2 on rays that hit
# (t < 10) and |dt| / (1 + t) <= 2e-3 on all rays, normals to 5e-3 on hit
# rays.
MARCH_TOLS = {"max_abs_err_t_hit": 1e-2, "max_rel_err_t_all": 2e-3,
              "max_abs_err_normal_hit": 5e-3}
HIT_T = 10.0

# K6's output and gradients, in k6_run's order after the output.
K6_GRADS = ("d_centers", "d_colors", "d_radii", "d_light", "d_ambient")

# Scores this close (relative to 1 + |score|) may be ordered, or cut, apart
# by K7 and the plain selection: the two round a few operations differently
# (PyTorch's reduction orders).
K7_SCORE_TOL = 1e-6
# K7's cones (apex, axis, cos_half, origin_spread) against tile_cones': the
# kernel sums the means in another order. The slots are held against the
# plain selection on K7's own cones (K7_SCORE_TOL), so a wrong cone fails
# here: on config 4's narrow tiles a cone gap of ~4e-7 already moves scores
# by ~2e-5 of 1 + |score|, which puts the slots past K7_SCORE_TOL.
K7_CONE_TOL = 1e-6

# The card's peaks for ``bound`` (NVIDIA's data sheet, H100 SXM): device
# memory, FP32 outside the tensor cores, and the special-function units at
# 16 lanes a clock on each of 132 SMs at the 1,980 MHz maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9


# --- timers and the bound ------------------------------------------------- #

def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, in ms (the
    host's launch work included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: the call is captured into a CUDA graph
    ``launches`` times and the graph replayed between CUDA events, so the
    host's launch work (which exceeds a 0.1 ms kernel's own time) does not
    enter. Median over ``reps`` replays. Warm-up and capture share one side
    stream, so that a ``fn`` that runs autograd finds its nodes there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound(nbytes: float, sfu_ops: float = 0.0, flops: float = 0.0) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its operations over their peak rate: special-function
    operations (one sqrt, exp or reciprocal each) over the SFU rate, other
    floating-point operations over the FP32 rate → {"bound_ms", "bound_by":
    "bytes" or "operations"}."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(sfu_ops / SFU_OPS_PER_S, flops / FP32_FLOP_PER_S)
    return {"bound_ms": 1000.0 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def march_bound(pairs: float, *tensors) -> dict:
    """K1 / K3 / K5: one sqrt and one exp per (point, live primitive) pair,
    with ~12 other FP32 operations around them; ``tensors`` are read or
    written once."""
    return bound(tensor_bytes(*tensors), sfu_ops=2.0 * pairs,
                 flops=12.0 * pairs)


def k7_bound(ro, rows: int, tiles: int, slots: int) -> dict:
    """K7's least time: the rays, the table (centers, radius, mask byte)
    and the K slots written (idx 8, valid 1, cs 12, rs 4, qs 4 bytes) once;
    per (tile, row) 3 SFU operations (two sqrt, a divide) and ~25 other
    FP32 ones, per ray 1 sqrt and ~20 FP32 for the cone."""
    rays = ro.shape[0]
    return bound(2 * tensor_bytes(ro) + 17.0 * rows + 29.0 * tiles * slots,
                 sfu_ops=3.0 * tiles * rows + rays,
                 flops=25.0 * tiles * rows + 20.0 * rays)


# --- checks --------------------------------------------------------------- #

def march_errors(t_k, n_k, t_p, n_p) -> dict:
    """A march (t, normals) against its reference (``t_p``, ``n_p``): the
    largest |dt| on rays the reference hits (t < HIT_T), with its median and
    99th percentile, the largest |dt| / (1 + t) on all rays, and the
    largest normal component gap on hit rays with its median and 99th
    percentile."""
    t_k, t_p = t_k.reshape(-1, 1), t_p.reshape(-1, 1)
    n_k, n_p = n_k.reshape(-1, 3), n_p.reshape(-1, 3)
    hit = t_p[:, 0] < HIT_T
    dt = (t_k - t_p).abs()[:, 0]
    dn = (n_k - n_p).abs().amax(dim=1)
    return {
        "hit_rays": int(hit.sum()),
        "max_abs_err_t_hit": dt[hit].max().item(),
        "p50_abs_err_t_hit": torch.quantile(dt[hit], 0.5).item(),
        "p99_abs_err_t_hit": torch.quantile(dt[hit], 0.99).item(),
        "max_rel_err_t_all": (dt / (1.0 + t_p[:, 0].abs())).max().item(),
        "max_abs_err_normal_hit": dn[hit].max().item(),
        "p50_abs_err_normal_hit": torch.quantile(dn[hit], 0.5).item(),
        "p99_abs_err_normal_hit": torch.quantile(dn[hit], 0.99).item(),
    }


def march_noise_tols(t_p, n_p, t_64, n_64) -> dict:
    """Tolerances from the float32 noise of the march itself: 5x the plain
    version's own error against the same march in float64, plus 1e-5, for
    each key of MARCH_TOLS. At k = 128 around spheres of radius ~0.03 the
    cancellation error of the expanded |p - c|^2 (~ulp(|p|^2)) becomes
    ~2e-6 in the distance, which the normal's 1/(2 eps) difference scales
    to ~1e-2 and the march carries into t on grazing rays. A kernel that
    rounds no worse than the plain version stays within about twice that
    noise of it; each figure is a maximum over a few thousand rays, decided
    by the few worst-conditioned ones, and two roundings of those differ by
    up to 2.6x more (warm t: 1.9e-4 against a float64 error of 5.2e-5,
    H100)."""
    noise = march_errors(t_p, n_p, t_64.to(t_p.dtype), n_64.to(n_p.dtype))
    return {key: 5.0 * noise[key] + 1e-5 for key in MARCH_TOLS}


def march_excess(errs: dict, tols: dict) -> dict:
    """The keys of ``tols`` whose error in ``errs`` is not finite or
    exceeds its tolerance → {key: (error, tolerance)}; empty when the march
    holds."""
    return {key: (errs[key], tol) for key, tol in tols.items()
            if not errs[key] <= tol}


def float64_gaps(t_k, n_k, t_p, n_p, t_64, n_64) -> dict:
    """The kernel's and the plain float32 version's gaps to the same march
    in float64 (``march_errors`` of each), and the plain version's gap on
    the rays where the kernel's is largest: a worst ray that is
    ill-conditioned is far off in every float32 rounding, the plain one
    included."""
    t_64, n_64 = t_64.float(), n_64.float()
    out = {"plain_vs_float64": march_errors(t_p, n_p, t_64, n_64),
           "kernel_vs_float64": march_errors(t_k, n_k, t_64, n_64)}
    hit = t_64.reshape(-1) < HIT_T
    for key, a_k, a_p, a_64 in (("t", t_k, t_p, t_64),
                                ("normal", n_k, n_p, n_64)):
        width = a_64.reshape(hit.numel(), -1).shape[1]
        gap_k, gap_p = (((a - a_64).abs().reshape(-1, width).amax(dim=1)
                         * hit) for a in (a_k, a_p))
        worst = int(gap_k.argmax())
        out[f"kernels_worst_{key}_ray"] = {
            "kernel_gap": gap_k[worst].item(),
            "plain_gap": gap_p[worst].item(),
            "hit_rays_where_plain_gap_exceeds_it": int(
                (gap_p > gap_k[worst]).sum())}
    return out


def k6_run(tail, inp, cot, dtype=None) -> list:
    """The culled tail ``tail`` (culled_shade or its plain version) on
    ``k6_inputs``' ``inp``, in ``dtype`` → [out, its five gradients
    (K6_GRADS) under sum(out cot)]."""
    dtype = dtype or torch.float32
    ro3, rd3, t, normal, cs, cols, rs, valid, light, amb = inp
    leaves = [x.to(dtype).clone().requires_grad_()
              for x in (cs, cols, rs, light, amb)]
    out = tail(ro3.to(dtype), rd3.to(dtype), t.to(dtype), normal.to(dtype),
               leaves[0], leaves[1], leaves[2], valid, leaves[3], leaves[4],
               C4_K, *C4_SHARPNESS)
    grads = torch.autograd.grad(torch.sum(out * cot.to(dtype)), leaves)
    return [out.detach(), *grads]


def k7_compare(ro, rd, c, r, k, budget, mask, out) -> dict:
    """K7's output ``out`` (launch_tile_select's six tensors, with_cones)
    against the plain selection (select_tile_primitives) run on K7's own
    cones: every slot equal but where a score lies within K7_SCORE_TOL of
    the one the plain table holds there (a swap of near-equal neighbours),
    of the tile's cutoff or, in a tile keeping more than K, of its K-th
    score; the invalid tail ascending; cs, rs, qs bitwise the gathers of
    K7's idx; the cones within K7_CONE_TOL of tile_cones' → counts ("bad"
    must be 0)."""
    from burn_raymarching_tpu_torch.ops.culling import (
        CULL_MARGIN,
        TileCones,
        cone_point_distance,
        select_tile_primitives,
        selected_tables,
        tile_cones,
    )

    idx, valid, cs, rs, qs, cones = out
    tile = ro.shape[0] // idx.shape[0]
    own = TileCones(cones[:, 0:3], cones[:, 3:6], cones[:, 6], cones[:, 7])
    cone_gap = max(float((a - b).abs().max())
                   for a, b in zip(own, tile_cones(ro, rd, tile)))
    idx_p, valid_p = select_tile_primitives(own, c, r, k, budget, mask=mask)
    score = cone_point_distance(own, c) - r.reshape(1, -1)
    cutoff = CULL_MARGIN / float(k) + own.origin_spread
    kept = score <= cutoff[:, None]
    if mask is not None:
        kept = kept & mask.reshape(1, -1).bool()
    s, cut = score.cpu().numpy(), cutoff.cpu().numpy()
    n_kept = kept.sum(dim=1).cpu().numpy()
    ik, vk = idx.cpu().numpy(), valid.cpu().numpy()
    ip, vp = idx_p.cpu().numpy(), valid_p.cpu().numpy()
    kk = ik.shape[1]

    def near(x, y):
        return abs(float(x) - float(y)) <= K7_SCORE_TOL * (1.0 + abs(float(y)))

    bad = near_swaps = 0
    for b in np.nonzero((ik != ip).any(axis=1) | (vk != vp).any(axis=1))[0]:
        kth = s[b, ip[b, kk - 1]] if n_kept[b] > kk else None
        for j in np.nonzero((ik[b] != ip[b]) | (vk[b] != vp[b]))[0]:
            a, p = ik[b, j], ip[b, j]
            if vk[b, j] and vp[b, j]:
                ok = near(s[b, a], s[b, p])
            elif vk[b, j] or vp[b, j]:
                row = a if vk[b, j] else p
                ok = near(s[b, row], cut[b]) or (
                    kth is not None and near(s[b, row], kth))
            else:
                # Two invalid rows: the tails differ only if the kept sets do.
                ok = not np.array_equal(np.sort(ik[b][vk[b]]),
                                        np.sort(ip[b][vp[b]]))
            bad += not ok
            near_swaps += 1
    tail_ascending = all(bool(np.all(np.diff(ik[b][~vk[b]]) > 0))
                         for b in range(ik.shape[0]))
    gathers = all(torch.equal(a, b) for a, b in
                  zip((cs, rs, qs), selected_tables(c, r, idx, valid)))
    bad += ((not tail_ascending) + (not gathers)
            + (not cone_gap <= K7_CONE_TOL))
    return {"bad": int(bad), "slots_apart_within_tol": int(near_swaps),
            "tiles_equal": int(((ik == ip).all(axis=1)
                                & (vk == vp).all(axis=1)).sum()),
            "tiles": int(ik.shape[0]), "tail_ascending": tail_ascending,
            "gathers_bitwise": gathers, "cone_max_abs_gap": cone_gap,
            "kept_per_tile_max": int(n_kept.max()),
            "tiles_over_k": int((n_kept > kk).sum()),
            "valid_slots": int(vk.sum())}


def u8_gaps(a, b) -> dict:
    """Two linear RGB frames [pixels, 3] → the mean |du8| and the share of
    channels more than 2 LSB off as the viewer writes them (gamma 2.2,
    uint8), and the share of pixels lit (any channel above 0) in one frame
    and black in the other."""
    def u8(img):
        img = np.clip(np.asarray(img), 0, 1)
        return (img ** (1 / 2.2) * 255).astype(np.int32)

    diff = np.abs(u8(a) - u8(b))
    lit_a, lit_b = (np.asarray(x).reshape(-1, 3).sum(1) > 0 for x in (a, b))
    return {"mean_lsb": float(diff.mean()),
            "share_over_2_lsb": float((diff > 2).mean()),
            "lit_mismatch_share": float((lit_a != lit_b).mean())}


# --- inputs --------------------------------------------------------------- #

def main_path_inputs(dev, live: int = M_LIVE, slots: int = M_SLOTS):
    """N_RAYS rays drawn from the dango rig's 10 views at 256², and a
    ``slots``-slot table with ``live`` random primitives (seeded) →
    (ro, rd, padded params, mask, activate, a cotangent [N_RAYS, 3])."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.models.scene import (
        activate,
        init_scene_params,
        pad_params,
    )
    from burn_raymarching_tpu_torch.tools.generate import default_cameras

    rng = np.random.default_rng(0)
    ro_all, rd_all = [], []
    for cam in default_cameras():
        ro, rd = create_camera_rays(256, 256, cam["origin"], cam["target"],
                                    cam["fov"], device=dev)
        ro_all.append(ro)
        rd_all.append(rd)
    pick = torch.as_tensor(rng.choice(10 * 65536, N_RAYS, replace=False),
                           device=dev)
    ro = torch.cat(ro_all)[pick].contiguous()
    rd = torch.cat(rd_all)[pick].contiguous()
    params = init_scene_params(live, device=dev)
    with torch.no_grad():
        params.centers.copy_(torch.as_tensor(
            rng.normal(0, 0.3, (live, 3)), device=dev))
        params.radii.copy_(torch.as_tensor(
            rng.normal(-2.0, 0.3, (live, 1)), device=dev))
        params.colors.copy_(torch.as_tensor(
            rng.normal(0, 1.5, (live, 3)), device=dev))
        params.light_dir.copy_(torch.tensor([0.3, 1.0, -0.4], device=dev))
    padded, mask = pad_params(params, slots)
    cot = torch.as_tensor(rng.normal(0, 1, (N_RAYS, 3)), dtype=torch.float32,
                          device=dev)
    return ro, rd, padded, mask, activate, cot


def knot_cloud(dev, n: int, gt_n: int = C4_GT_N):
    """The prior-seeded cloud init of ``n`` spheres around the generator's
    ``gt_n``-sphere knot (points.json, jitter 0.02), padded to its bucket →
    (padded, mask, centers, radii) with the last two activated and
    detached."""
    from burn_raymarching_tpu_torch.models.scene import (
        activate,
        init_scene_params_cloud,
        pad_params,
    )
    from burn_raymarching_tpu_torch.tools.generate import knot_scene
    from burn_raymarching_tpu_torch.utils import bucket_size

    pts, _, _ = knot_scene(gt_n)
    params = init_scene_params_cloud(n, seed=0, points=pts, jitter=0.02,
                                     device=dev)
    padded, mask = pad_params(params, bucket_size(n))
    c, _, r, _, _ = activate(padded)
    return padded, mask, c.detach(), r.detach()


def c4_tiles(dev, c, r, mask, size: int = C4_SIZE, views: int = C4_VIEWS,
             budget: int = C4_BUDGET, tiles: int = C4_TILES, draw: int = 4):
    """``tiles`` tile-coherent ray tiles of the config-4 rig (or another
    knot rig of ``views`` views at ``size``²) and their top-``budget``
    tables: the Morton tiles of ``draw`` random views, selected against the
    whole primitive table, ``tiles`` picked among those whose selection is
    not empty → ((ro3, rd3, cs, rs, qs), valid-slot counts)."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching_tpu_torch.tools.generate import ring_cameras
    from burn_raymarching_tpu_torch.utils import morton_permutation

    rng = np.random.default_rng(0)
    perm = torch.as_tensor(morton_permutation(size, size), device=dev)
    cams = ring_cameras(views)
    ro_all, rd_all = [], []
    for v in rng.choice(views, draw, replace=False):
        ro, rd = create_camera_rays(size, size, cams[v]["origin"],
                                    cams[v]["target"], cams[v]["fov"],
                                    device=dev)
        ro_all.append(ro[perm])
        rd_all.append(rd[perm])
    ro, rd = torch.cat(ro_all), torch.cat(rd_all)
    idx, valid = select_tile_primitives(tile_cones(ro, rd, C4_TILE), c, r,
                                        C4_K, budget, mask=mask)
    live = torch.nonzero(valid.sum(dim=1) > 0)[:, 0].cpu().numpy()
    pick = torch.as_tensor(np.sort(rng.choice(live, tiles, replace=False)),
                           device=dev)
    idx, valid = idx[pick], valid[pick]
    cs = c[idx]
    rs = r.reshape(-1)[idx]
    qs = torch.where(valid, torch.sum(cs * cs, dim=2),
                     torch.full_like(rs, 1e30))
    ro3 = ro.reshape(-1, C4_TILE, 3)[pick].contiguous()
    rd3 = rd.reshape(-1, C4_TILE, 3)[pick].contiguous()
    counts = valid.sum(dim=1)
    return (ro3, rd3, cs, rs, qs), {"valid_per_tile_min": int(counts.min()),
                                    "valid_per_tile_max": int(counts.max()),
                                    "valid_slots": int(counts.sum())}


def chunked_tiles(dev, ro3, rd3):
    """K3 inputs for its chunked path: the first CHUNKED_TILES ray tiles,
    each against the same CHUNKED_K live primitives drawn evenly from the
    51,200-sphere cloud (more columns than the resident table holds)."""
    _, _, c, r = knot_cloud(dev, LARGE_INIT_N)
    pick = torch.arange(0, LARGE_INIT_N, LARGE_INIT_N // CHUNKED_K,
                        device=dev)[:CHUNKED_K]
    cs = c[pick][None].expand(CHUNKED_TILES, -1, -1).contiguous()
    rs = r.reshape(-1)[pick][None].expand(CHUNKED_TILES, -1).contiguous()
    return (ro3[:CHUNKED_TILES].contiguous(),
            rd3[:CHUNKED_TILES].contiguous(), cs, rs,
            torch.sum(cs * cs, dim=2))


def full_tables(args, c, r, mask):
    """K3 inputs of the first 4 ray tiles of ``args`` (c4_tiles'), each
    against the first C4_BUDGET live primitives: every slot valid."""
    ids = torch.nonzero(mask.reshape(-1))[:C4_BUDGET, 0]
    cs = c[ids][None].expand(4, -1, -1).contiguous()
    rs = r.reshape(-1)[ids][None].expand(4, -1).contiguous()
    return (args[0][:4].contiguous(), args[1][:4].contiguous(), cs, rs,
            torch.sum(cs * cs, dim=2))


def k6_inputs(dev, args):
    """K6's inputs on K3's tiles and tables (ro3, rd3, cs, rs, qs): t and
    normal from K3's cold march, colours drawn from a fixed seed, config 4's
    light and ambient at init → ((ro3, rd3, t, normal, cs, colours, rs,
    valid, light, ambient), a cotangent of the output)."""
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3

    ro3, rd3, cs, rs, qs = args
    gen = torch.Generator().manual_seed(6)
    cols = torch.rand(cs.shape, generator=gen).to(dev)
    cot = torch.randn((ro3.shape[0] * ro3.shape[1], 3), generator=gen).to(dev)
    t, normal = k3.culled_march_normals(*args, C4_K)
    light = torch.tensor([0.3, 1.0, -0.4], device=dev)
    amb = torch.tensor([0.2], device=dev)
    return (ro3, rd3, t, normal, cs, cols, rs, qs < 1e29, light, amb), cot


def dryrun_k3_inputs(dev) -> dict:
    """The tables K3 marches in the dry run's parts (d) and (e)
    (tools/dryrun_multichip): the 12-sphere cloud init of the dry run's
    trainers on the 32 x 32 rig, in tiles of 16 rays at the first step's
    smooth_k. Of the rig's 64 tiles, the two in which the plain march
    against every sphere hits most rays form the batch (a random batch of
    two tiles hits none of the 0.03-radius spheres on most draws). Part
    (d), ``kernel``: the flat top-8 per tile ([2, 16] rays, K = 8). Part
    (e), ``union``, at 1 x 2: each model shard's hierarchical top-8
    (cluster group 8, cluster budget 2) of its half of the Morton-sorted
    rows, padded to the DistributedTrainer's bucket of 16, joined in rank
    order as the union table, of which model rank 0 marches its one tile
    ([1, 16] rays, 2 x 8 slots) → {part: (ro3, rd3, cs, rs, qs, smooth_k,
    cfg)}."""
    from burn_raymarching_tpu_torch.config import TrainConfig
    from burn_raymarching_tpu_torch.models.scene import (
        SceneParams,
        activate,
        pad_params,
    )
    from burn_raymarching_tpu_torch.ops.culling import (
        PrimitiveClusters,
        morton_order,
    )
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )
    from burn_raymarching_tpu_torch.tools import dryrun_multichip as dm
    from burn_raymarching_tpu_torch.train.loop import Trainer
    from burn_raymarching_tpu_torch.train.step_body import (
        culled_tables,
        schedule_for_step,
    )

    ds = dm.rig_dataset(dev)
    ro_all, rd_all = ds.packed[:, :3], ds.packed[:, 3:6]
    out = {}
    for part, kw, model in (("kernel", dm.CFG_K, 1),
                            ("union", dm.CFG_FULL, 2)):
        cfg = TrainConfig(batch_size=32, **kw)
        tr = Trainer(cfg, ds, log=lambda s: None)
        params = tr._init_params()
        _, k, _, _ = schedule_for_step(cfg, 0, 1)
        tile = cfg.cull_tile
        with torch.no_grad():
            c, _, r, _, _ = activate(params)
            n_tiles = ro_all.shape[0] // tile
            t_all, _ = culled_march_normals_xla(
                ro_all.reshape(n_tiles, tile, 3),
                rd_all.reshape(n_tiles, tile, 3),
                c.expand(n_tiles, -1, -1), r.reshape(1, -1).expand(
                    n_tiles, -1), (c * c).sum(dim=1).expand(n_tiles, -1), k)
            hits = (t_all[..., 0] < HIT_T).sum(dim=1)
            tiles = torch.sort(torch.topk(hits, 2).indices).values
            rows = (tiles[:, None] * tile
                    + torch.arange(tile, device=dev)).reshape(-1)
            ro, rd = ro_all[rows], rd_all[rows]
            if model == 1:
                padded, mask = pad_params(params, tr._bucket(params.n))
                c, _, r, _, _ = activate(padded)
                _, _, cs, rs, qs = culled_tables(cfg, ro, rd, c, r, k, mask)
            else:
                order = torch.as_tensor(morton_order(c.cpu().numpy()),
                                        device=dev)
                padded, mask = pad_params(SceneParams(
                    params.centers[order], params.colors[order],
                    params.radii[order], params.light_dir, params.ambient),
                    16)
                c, _, r, _, _ = activate(padded)
                m_local, g = 16 // model, cfg.cull_cluster_group
                shards = []
                for m in range(model):
                    own = slice(m * m_local, (m + 1) * m_local)
                    clusters = PrimitiveClusters(
                        torch.arange(m_local, device=dev).reshape(-1, g),
                        mask[own].bool().reshape(-1, g))
                    shards.append(culled_tables(
                        cfg, ro, rd, c[own], r[own], k, mask[own],
                        clusters)[2:])
                cs, rs, qs = (torch.cat([sh[i] for sh in shards], dim=1)[:1]
                              for i in range(3))
                ro, rd = ro[:tile], rd[:tile]
        b = ro.shape[0] // tile
        out[part] = (ro.reshape(b, tile, 3).contiguous(),
                     rd.reshape(b, tile, 3).contiguous(), cs.contiguous(),
                     rs.contiguous(), qs.contiguous(), k, cfg)
    return out

#!/usr/bin/env python3
"""Times the hand-written kernels on one GPU, of this tree or of another
tree beside this one's: K1 dense march, K2 shade, K3 culled march, K4
cluster repulsion, K5 march variants, K6 culled tail, K7 per-tile
selection.

The inputs, checks, timers and bounds are this tree's ``kernel_cases.py``,
which this script loads by its path (the file beside it), and the cases
drive only the wrappers' public signatures. So ``--root`` can point at an
unpacked copy of an older commit, whose package is then timed on this
tree's cases; to compare two commits, run both in one call on one card, in
turns (old, new, new, old):

    python burn_raymarching_tpu_torch/tools/bench_kernels.py --root old_tree
    python burn_raymarching_tpu_torch/tools/bench_kernels.py

Cases: K1 at config 1's table widths (7 live in 8 slots, 25 in 32, 100 in
128; 16,384 dango rays, 40 steps); K2 (``shade_fused``) at 100 live of 128
slots and 10 of 16; K3 at config 4's shape (32 tiles x 512 rays, K = 2,048,
k = 128) cold (40 steps) and warm (16), its chunked path (8 tiles, 8,192
live columns), and the config-4 shape with every slot live (no imbalance
between tiles); K4 (``repulsion_sum``) at C = 80 and C = 800, member and
monopole; K5 (``variant_march``) in its eight variants at the variant
tool's shape (16,384 rays, 100 live of 128 slots, 128 rays a block), 40
and 16 steps; K6 (``culled_shade``) on config 4's 32 tiles and on 4 tiles
of 2,048 valid slots each; K7 (``tile_select``) on config 4's 32 tiles at
config 4's step table (8,192 slots of 5,120 spheres, K = 2,048), a later
stage's prefill table (2,048 slots of 1,340 spheres) and the bench
flagship's prefill (51,200 rows, K = 256).

Per case one JSON line: ``ms`` (the wrapper call between CUDA events, the
host's launch work included), ``device_ms`` (the same call replayed from a
CUDA graph), ``bound_ms`` and ``bound_by`` (``kernel_cases.bound``: the
least time the card could take) and the errors against the plain float32
version. For the kernels with a backward (K2, K4, K6) these are the
forward's, and ``bwd_ms``, ``bwd_device_ms`` (forward + backward less the
forward) and ``bwd_bound_ms`` stand beside them. The marches (K1, K3, K5)
also give both versions' gaps to the same march in float64
(``kernel_cases.float64_gaps``); they and K7 give ``output_sha256``, a
digest of the output's bits, equal between two trees whose kernels agree
bitwise. K7's errors are ``kernel_cases.k7_compare``'s counts. The first
line is the launch of an empty kernel, timed the same way. Every line names
the tree and the card. ``--only`` picks kernels (default all), ``--out``
appends the lines to a file as well.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
# K7's shapes on config 4's 32 ray tiles: (label, seeded spheres, rows kept
# of the padded table or None for all, K). The step's table; a later
# stage's prefill, whose ~1,340 spheres fill 2,048 slots and K holds every
# row; the bench flagship's prefill, where tiles keep more rows than K and
# than shared memory holds.
K7_SHAPES = (("c4_step", 5120, None, 2048),
             ("c4_prefill", 1340, None, 2048),
             ("flagship", 51200, 51200, 256))


def load_cases():
    """This tree's kernel_cases.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "kernel_cases", os.path.join(HERE, "kernel_cases.py"))
    kc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kc)
    return kc


def digest(*outputs) -> str:
    """A digest of a kernel's output bits: two trees whose digests agree
    computed bitwise the same outputs."""
    return hashlib.sha256(b"".join(x.cpu().numpy().tobytes()
                                   for x in outputs)).hexdigest()[:16]


def bound_fields(b: dict, prefix: str = "") -> dict:
    return {f"{prefix}bound_ms": b["bound_ms"],
            f"{prefix}bound_by": b["bound_by"]}


def measure(torch, kc, kernel, plain, args, kw, pairs: float) -> dict:
    """One march case (K1, K3, K5): times, the bound of ``pairs`` (point,
    live primitive) evaluations, errors against the plain version and both
    versions' gaps to float64, and the output's digest."""
    def f64(v):
        floating = torch.is_tensor(v) and v.is_floating_point()
        return v.double() if floating else v

    t_k, n_k = kernel(*args, **kw)
    t_p, n_p = plain(*args, **kw)
    t_64, n_64 = plain(*map(f64, args),
                       **{key: f64(v) for key, v in kw.items()})
    tensors = [a for a in (*args, *kw.values()) if torch.is_tensor(a)]
    return {"ms": kc.time_ms(lambda: kernel(*args, **kw)),
            "device_ms": kc.graph_ms(lambda: kernel(*args, **kw)),
            **bound_fields(kc.march_bound(pairs, *tensors, t_k, n_k)),
            "kernel_vs_plain": kc.march_errors(t_k, n_k, t_p, n_p),
            **kc.float64_gaps(t_k, n_k, t_p, n_p, t_64, n_64),
            "output_sha256": digest(t_k, n_k)}


def fwd_bwd(torch, kc, fn, leaves, cot, plain, fwd_bound: dict,
            bwd_bound: dict) -> dict:
    """A differentiable wrapper ``fn(*leaves)`` and its plain version: times
    of the forward alone and of forward + backward (autograd with the
    cotangent ``cot``), the backward as their difference, both bounds, and
    the errors of the value and of the gradients relative to each plain
    gradient's largest entry."""
    def forward():
        with torch.no_grad():
            return fn(*leaves)

    def both(f=fn):
        # Fresh leaves per call: their autograd nodes then belong to the
        # stream the call runs on (a CUDA-graph capture needs that).
        fresh = [x.detach().requires_grad_() for x in leaves]
        out = f(*fresh)
        return out, torch.autograd.grad(out, fresh, cot, allow_unused=True)

    out_k, g_k = both()
    out_p, g_p = both(plain)
    res = {"ms": kc.time_ms(forward), "device_ms": kc.graph_ms(forward),
           **bound_fields(fwd_bound),
           "fwd_max_abs_err": (out_k - out_p).abs().max().item(),
           "fwd_max_rel_err": ((out_k - out_p).abs().max()
                               / out_p.abs().max()).item(),
           "grad_err_rel_to_max": max(
               ((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(g_k, g_p) if b is not None),
           "fwd_bwd_ms": kc.time_ms(both),
           "fwd_bwd_device_ms": kc.graph_ms(both)}
    res["bwd_ms"] = res["fwd_bwd_ms"] - res["ms"]
    res["bwd_device_ms"] = res["fwd_bwd_device_ms"] - res["device_ms"]
    res.update(bound_fields(bwd_bound, "bwd_"))
    return res


def run_k1(torch, kc, dev) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1

    rows = []
    ro, rd, padded, _, activate, _ = kc.main_path_inputs(dev)
    with torch.no_grad():
        c_all, _, r_all, _, _ = activate(padded)
    for live, slots in (*kc.K1_NARROW, (kc.M_LIVE, kc.M_SLOTS)):
        c = torch.zeros((slots, 3), device=dev)
        r = torch.zeros((slots, 1), device=dev)
        c[:live], r[:live] = c_all[:live], r_all[:live]
        mask = torch.arange(slots, device=dev) < live
        res = measure(torch, kc, k1.march_shade, k1.march_shade_plain,
                      (ro, rd, c, r, kc.K1_K), dict(mask=mask),
                      ro.shape[0] * live * 47.0)
        rows.append({"kernel": "K1", "case": f"cold M={slots} live={live}",
                     **res})
    return rows


def run_k2(torch, kc, dev) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import (
        march_shade_kernel as k1,
        shade_kernel as k2,
    )

    rows = []
    for live, slots in ((kc.M_LIVE, kc.M_SLOTS), kc.K2_NARROW):
        ro, rd, padded, mask, activate, cot = kc.main_path_inputs(
            dev, live, slots)
        with torch.no_grad():
            c, col, r, ld, amb = activate(padded)
            t, n = k1.march_shade(ro, rd, c, r, kc.K1_K, mask=mask)
        leaves = [x.clone().requires_grad_() for x in (c, r, col, ld, amb)]

        def call(f):
            return lambda *p: f(ro, rd, t, n, *p, kc.K1_K, mask=mask)

        # Per (ray, live primitive) pair 5 SFU operations (a sqrt and an
        # exp for the soft-min at the march's point, a sqrt and two exps at
        # the reattached one), ~30 other FP32 forward and ~60 backward,
        # which recomputes them.
        pairs = float(ro.shape[0] * live)
        rays_in = kc.tensor_bytes(ro, rd, t, n, c, r, col)
        out_bytes = kc.tensor_bytes(cot)
        res = fwd_bwd(torch, kc, call(k2.shade_fused), leaves, cot,
                      call(k2.shade_plain),
                      kc.bound(rays_in + out_bytes, sfu_ops=5.0 * pairs,
                               flops=30.0 * pairs),
                      kc.bound(rays_in + out_bytes + kc.tensor_bytes(*leaves),
                               sfu_ops=5.0 * pairs, flops=60.0 * pairs))
        rows.append({"kernel": "K2", "case": f"M={slots} live={live}", **res})
    return rows


def run_k3(torch, kc, dev) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )

    def case(args, steps, t_init=None):
        valid_slots = int((args[4] < 1e29).sum())
        return measure(torch, kc, k3.culled_march_normals,
                       culled_march_normals_xla, (*args, kc.C4_K),
                       dict(num_steps=steps, t_init=t_init),
                       (steps + 7.0) * args[0].shape[1] * valid_slots)

    _, mask, c, r = kc.knot_cloud(dev, kc.C4_INIT_N)
    args, stats = kc.c4_tiles(dev, c, r, mask)
    # Warm marches start from 0.8 of the plain cold march's t.
    t_init = (culled_march_normals_xla(*args, kc.C4_K)[0] * 0.8).contiguous()
    rows = [{"kernel": "K3", "case": f"{label} K={kc.C4_BUDGET}", **stats,
             **case(args, steps, t0)}
            for label, steps, t0 in (("cold", 40, None),
                                     ("warm16", 16, t_init))]

    ch_args = kc.chunked_tiles(dev, args[0], args[1])
    rows.append({"kernel": "K3",
                 "case": f"chunked warm-length K={kc.CHUNKED_K}",
                 **case(ch_args, 16)})
    # The resident kernel without tile imbalance: every tile marches the
    # same 2,048 live columns (config 4's budget, all slots live).
    n_tiles = args[0].shape[0]
    full = [x[:1, :kc.C4_BUDGET].expand(
        n_tiles, kc.C4_BUDGET, *x.shape[2:]).contiguous()
        for x in ch_args[2:]]
    rows.append({"kernel": "K3",
                 "case": f"warm16 K={kc.C4_BUDGET} all slots live",
                 **case((args[0], args[1], *full), 16, t_init)})
    return rows


def run_k4(torch, kc, dev) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4
    from burn_raymarching_tpu_torch.ops.culling import build_clusters
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static

    rows = []
    for n in (kc.C4_INIT_N, kc.LARGE_INIT_N):
        _, mask, c, _ = kc.knot_cloud(dev, n)
        clusters = build_clusters(c.cpu().numpy(), mask=mask.cpu().numpy(),
                                  group=64, device=dev)
        static = build_repulsion_static(c, clusters, mask)
        planes, *_ = k4.repulsion_planes(c, clusters, mask, static=static)
        for far_field in ("member", "monopole"):
            include_far = far_field != "monopole"
            leaves = [x.clone().requires_grad_() for x in planes[:3]]

            def call(f):
                return lambda *p: f(*p, *planes[3:], include_far)

            # Per pair a sqrt and a reciprocal, forward and backward, among
            # ~12 (forward) and ~25 (backward) other FP32 operations; pairs
            # C·G·(W·G + the C_all far centroids of the member far field).
            c_dim, g_dim = planes[0].shape[1], planes[0].shape[2]
            pairs = float(c_dim * g_dim * (planes[1].shape[2] + (
                planes[2].shape[1] if include_far else 0)))
            table = kc.tensor_bytes(*planes)
            res = fwd_bwd(torch, kc, call(k4.repulsion_sum), leaves,
                          torch.ones((), device=dev),
                          call(k4.repulsion_sum_plain),
                          kc.bound(table, sfu_ops=2.0 * pairs,
                                   flops=12.0 * pairs),
                          kc.bound(table + kc.tensor_bytes(*leaves),
                                   sfu_ops=2.0 * pairs, flops=25.0 * pairs))
            rows.append({"kernel": "K4", "case": f"C={c_dim} {far_field}",
                         **res})
    return rows


def run_k5(torch, kc, dev) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import (
        march_variants_kernel as k5,
    )
    from burn_raymarching_tpu_torch.tools import exp_march_variants as emv

    rows = []
    inp = emv.make_inputs(128, dev)
    live = int(inp["mask"].sum())
    for name, flags in emv.VARIANTS.items():
        args = (inp["ro"], inp["rd"], inp["t0"],
                inp["prim_far"] if flags[2] else inp["prim"], inp["c_sq"],
                inp["k_arr"])
        for steps in (40, emv.TIME_STEPS):
            tail = (steps, 128, *flags)

            def kernel(*a, tail=tail):
                return k5.variant_march(*a, *tail)

            def plain(*a, tail=tail):
                return k5.variant_march_plain(*a, *tail)

            res = measure(torch, kc, kernel, plain, args, {},
                          args[0].shape[0] * live * (steps + 7.0))
            rows.append({"kernel": "K5", "case": f"{name} {steps} steps",
                         **res})
    return rows


def run_k6(torch, kc, dev) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import culled_shade_kernel as k6

    rows = []
    _, mask, c, r = kc.knot_cloud(dev, kc.C4_INIT_N)
    args, _ = kc.c4_tiles(dev, c, r, mask)
    for label, tables in (("c4", args),
                          ("full_tables", kc.full_tables(args, c, r, mask))):
        inp, cot = kc.k6_inputs(dev, tables)
        ro3, rd3, t, normal, cs, cols, rs, valid, light, amb = inp
        got = kc.k6_run(k6.culled_shade, inp, cot)
        plain = kc.k6_run(k6.culled_shade_plain, inp, cot)
        plain64 = kc.k6_run(k6.culled_shade_plain, inp, cot, torch.float64)
        errs = {name: (g - p).abs().max().item() for name, g, p in
                zip(("out",) + kc.K6_GRADS, got, plain)}
        tols = {name: 5.0 * (p.double() - p64).abs().max().item() + 1e-5
                for name, p, p64 in zip(("out",) + kc.K6_GRADS, plain,
                                        plain64)}
        leaves = [x.clone().requires_grad_() for x in (cs, cols, rs, light,
                                                       amb)]

        def call(f):
            return lambda c_, col_, r_, l_, a_: f(
                ro3, rd3, t, normal, c_, col_, r_, valid, l_, a_, kc.C4_K,
                *kc.C4_SHARPNESS)

        # Per (ray, valid slot) pair 5 SFU operations forward and 5
        # backward, as counts.py counts K2's tail (the backward makes ~10:
        # it recomputes the distances).
        pairs = float(ro3.shape[1] * int(valid.sum()))
        rays = kc.tensor_bytes(ro3, rd3, t, normal, cot)
        table = kc.tensor_bytes(cs, cols, rs, valid)
        res = fwd_bwd(torch, kc, call(k6.culled_shade), leaves, cot,
                      call(k6.culled_shade_plain),
                      kc.bound(rays + table, sfu_ops=5.0 * pairs),
                      kc.bound(rays + table + kc.tensor_bytes(cs, cols, rs),
                               sfu_ops=5.0 * pairs))
        rows.append({"kernel": "K6", "case": label, "tiles": ro3.shape[0],
                     "rays_per_tile": ro3.shape[1], "table": valid.shape[1],
                     "valid_slots": int(valid.sum()),
                     "errs_vs_plain": errs, "tol": tols, **res})
    return rows


def run_k7(torch, kc, dev) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import tile_select_kernel as k7

    _, c4_mask, c4_c, c4_r = kc.knot_cloud(dev, kc.C4_INIT_N)
    args, _ = kc.c4_tiles(dev, c4_c, c4_r, c4_mask)
    ro, rd = args[0].reshape(-1, 3), args[1].reshape(-1, 3)
    tiles = args[0].shape[0]
    rows = []
    for label, n, keep, budget in K7_SHAPES:
        if n == kc.C4_INIT_N:
            c, r, mask = c4_c, c4_r, c4_mask
        else:
            _, mask, c, r = kc.knot_cloud(dev, n)
        if keep is not None:
            c, r, mask = (c[:keep].contiguous(), r[:keep].contiguous(),
                          mask[:keep].contiguous())
        call = (ro, rd, kc.C4_TILE, c, r, kc.C4_K, budget, mask)
        out = k7.launch_tile_select(*call, with_cones=True)
        cmp = kc.k7_compare(ro, rd, c, r, kc.C4_K, budget, mask, out)
        rows.append({
            "kernel": "K7", "case": f"{label} rows={c.shape[0]} K={budget}",
            "live": int(mask.sum()),
            "ms": kc.time_ms(lambda: k7.tile_select(*call)),
            "device_ms": kc.graph_ms(lambda: k7.launch_tile_select(*call)),
            **bound_fields(kc.k7_bound(ro, int(c.shape[0]), tiles,
                                       out[0].shape[1])),
            "vs_plain": cmp, "output_sha256": digest(*out[:5])})
    return rows


RUNS = {"K1": run_k1, "K2": run_k2, "K3": run_k3, "K4": run_k4,
        "K5": run_k5, "K6": run_k6, "K7": run_k7}


def run(root: str, only: tuple) -> list[dict]:
    # The package under test comes from ``root``; the cases always from
    # this tree's kernel_cases.py, which imports the package only inside
    # its functions.
    sys.path.insert(0, root)
    import torch

    kc = load_cases()
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a GPU")
    import burn_raymarching_tpu_torch  # noqa: F401  (sets TF32 off)
    from burn_raymarching_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    tag = {"root": os.path.relpath(root),
           "device": torch.cuda.get_device_name(0)}
    rows = [{"kernel": "empty", "case": "one launch",
             "ms": kc.time_ms(lambda: build.launch_noop(dev)),
             "device_ms": kc.graph_ms(lambda: build.launch_noop(dev))}]
    for name in KERNELS:
        if name in only:
            rows += RUNS[name](torch, kc, dev)
    return [{**row, **tag} for row in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="tree whose package is timed (default: this one)")
    ap.add_argument("--out", default="", help="append the lines to this file")
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="kernels to time, comma-separated")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(","))
    unknown = sorted(set(only) - set(KERNELS))
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose from {KERNELS}")
    lines = [json.dumps(row) for row in run(os.path.abspath(args.root),
                                            only)]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times the four hand-written kernels (K1 dense march, K2 shade, K3
culled march, K4 cluster repulsion) of another tree beside this one's, on
one GPU.

chip_smoke.py measures this tree's kernels; to compare two commits the old
one has to run in the same call on the same card. This script takes its
inputs, timers and error measures from this tree's chip_smoke.py and drives
only the wrappers' public signatures, so ``--root`` can point at an unpacked
copy of an older commit:

    python burn_raymarching_tpu_torch/tools/bench_kernels.py --root old_tree
    python burn_raymarching_tpu_torch/tools/bench_kernels.py

Cases: K1 at config 1's table widths (7 live in 8 slots, 25 in 32, 100 in
128; 16,384 dango rays, 40 steps); K3 at config 4's shape (32 tiles x 512
rays, K = 2,048, k = 128) cold (40 steps) and warm (16), its chunked path (8
tiles, 8,192 live columns), and the config-4 shape with every slot live (no
imbalance between tiles); K2 (``shade_fused``) at 100 live of 128 slots and
10 of 16, forward alone and forward + backward through autograd; K4
(``repulsion_sum``) at C = 80 and C = 800, member and monopole, the same
way. Per case one JSON line: ``ms`` (the wrapper call between CUDA events),
``device_ms`` (the same call replayed from a CUDA graph) and the errors
against the plain float32 version (K1, K3: also both versions' gaps to the
same march in float64, chip_smoke.float64_gaps; K1: also a digest of the
output's bits, equal between two trees whose kernels agree bitwise). For K2 and K4
``bwd_device_ms`` is forward + backward less the forward. ``--only`` picks
kernels, ``--out`` appends the lines to a file as well. The first line is
the launch of an empty kernel timed the same way, where the tree has one.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

K1_SHAPES = ((7, 8), (25, 32), (100, 128))
K1_K = 18.5


def measure(torch, cs, kernel, plain, args, kw) -> tuple[dict, object]:
    """One case → (times and errors, the plain version's t)."""
    def f64(v):
        floating = torch.is_tensor(v) and v.is_floating_point()
        return v.double() if floating else v

    t_k, n_k = kernel(*args, **kw)
    t_p, n_p = plain(*args, **kw)
    t_64, n_64 = plain(*map(f64, args),
                       **{key: f64(v) for key, v in kw.items()})
    return {"ms": cs.time_ms(torch, lambda: kernel(*args, **kw)),
            "device_ms": cs.graph_ms(torch, lambda: kernel(*args, **kw)),
            "kernel_vs_plain": cs.march_errors(torch, t_k, n_k, t_p, n_p),
            **cs.float64_gaps(torch, t_k, n_k, t_p, n_p, t_64, n_64)}, t_p


def fwd_bwd(torch, cs, fn, leaves, cot, plain) -> dict:
    """A differentiable wrapper ``fn(*leaves)`` and its plain version: times
    of the forward alone and of forward + backward (autograd with the
    cotangent ``cot``), errors of the value and of the gradients relative to
    each plain gradient's largest entry."""
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
    res = {"fwd_max_abs_err": (out_k - out_p).abs().max().item(),
           "fwd_max_rel_err": ((out_k - out_p).abs().max()
                               / out_p.abs().max()).item(),
           "grad_err_rel_to_max": max(
               ((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(g_k, g_p) if b is not None),
           "fwd_ms": cs.time_ms(torch, forward),
           "fwd_device_ms": cs.graph_ms(torch, forward),
           "fwd_bwd_ms": cs.time_ms(torch, both)}
    res["bwd_ms"] = res["fwd_bwd_ms"] - res["fwd_ms"]
    res["fwd_bwd_device_ms"] = cs.graph_ms(torch, both)
    res["bwd_device_ms"] = res["fwd_bwd_device_ms"] - res["fwd_device_ms"]
    return res


def run_k2(torch, cs, dev, tag) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import (
        march_shade_kernel as k1,
        shade_kernel as k2,
    )

    rows = []
    for live, slots in ((cs.M_LIVE, cs.M_SLOTS), cs.K2_NARROW):
        ro, rd, padded, mask, activate, cot = cs.main_path_inputs(
            torch, dev, live, slots)
        with torch.no_grad():
            c, col, r, ld, amb = activate(padded)
            t, n = k1.march_shade(ro, rd, c, r, K1_K, mask=mask)
        leaves = [x.clone().requires_grad_() for x in (c, r, col, ld, amb)]

        def call(f):
            return lambda *p: f(ro, rd, t, n, *p, K1_K, mask=mask)

        res = fwd_bwd(torch, cs, call(k2.shade_fused), leaves, cot,
                      call(k2.shade_plain))
        rows.append({"kernel": "K2", "case": f"M={slots} live={live}",
                     **res, **tag})
    return rows


def run_k4(torch, cs, dev, tag) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import repulsion_kernel as k4
    from burn_raymarching_tpu_torch.ops.culling import build_clusters
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static

    rows = []
    for n in (cs.C4_INIT_N, cs.LARGE_INIT_N):
        _, mask, c, _ = cs.knot_cloud(torch, dev, n)
        clusters = build_clusters(c.cpu().numpy(), mask=mask.cpu().numpy(),
                                  group=64, device=dev)
        static = build_repulsion_static(c, clusters, mask)
        planes, *_ = k4.repulsion_planes(c, clusters, mask, static=static)
        for far_field in ("member", "monopole"):
            include_far = far_field != "monopole"
            leaves = [x.clone().requires_grad_() for x in planes[:3]]

            def call(f):
                return lambda *p: f(*p, *planes[3:], include_far)

            res = fwd_bwd(torch, cs, call(k4.repulsion_sum), leaves,
                          torch.ones((), device=dev),
                          call(k4.repulsion_sum_plain))
            rows.append({"kernel": "K4",
                         "case": f"C={planes[3].shape[0]} {far_field}",
                         **res, **tag})
    return rows


def run(root: str, only: tuple) -> list[dict]:
    # The package under test comes from ``root``; the inputs always from
    # this tree's chip_smoke.py, whose input functions import the package
    # lazily.
    sys.path.insert(0, root)
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "..", "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a GPU")
    dev = torch.device("cuda", 0)
    tag = {"root": os.path.relpath(root),
           "device": torch.cuda.get_device_name(0)}
    from burn_raymarching_tpu_torch.ops.cuda import build

    rows = []
    if hasattr(build, "launch_noop"):
        rows.append({"kernel": "empty", "case": "one launch",
                     "ms": cs.time_ms(torch, lambda: build.launch_noop(dev)),
                     "device_ms": cs.graph_ms(
                         torch, lambda: build.launch_noop(dev)), **tag})
    if "K2" in only:
        rows += run_k2(torch, cs, dev, tag)
    if "K4" in only:
        rows += run_k4(torch, cs, dev, tag)
    if "K1" in only:
        rows += run_k1(torch, cs, dev, tag)
    if "K3" in only:
        rows += run_k3(torch, cs, dev, tag)
    return rows


def run_k1(torch, cs, dev, tag) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1

    rows = []
    ro, rd, padded, _, activate, _ = cs.main_path_inputs(torch, dev)
    with torch.no_grad():
        c_all, _, r_all, _, _ = activate(padded)
    for live, slots in K1_SHAPES:
        c = torch.zeros((slots, 3), device=dev)
        r = torch.zeros((slots, 1), device=dev)
        c[:live], r[:live] = c_all[:live], r_all[:live]
        mask = torch.arange(slots, device=dev) < live
        res, _ = measure(torch, cs, k1.march_shade, k1.march_shade_plain,
                         (ro, rd, c, r, K1_K), dict(mask=mask))
        # A digest of the kernel's output bits: two trees whose digests
        # agree compute bitwise the same t and normals.
        t_k, n_k = k1.march_shade(ro, rd, c, r, K1_K, mask=mask)
        res["output_sha256"] = hashlib.sha256(
            t_k.cpu().numpy().tobytes()
            + n_k.cpu().numpy().tobytes()).hexdigest()[:16]
        rows.append({"kernel": "K1", "case": f"cold M={slots} live={live}",
                     **res, **tag})
    return rows


def run_k3(torch, cs, dev, tag) -> list[dict]:
    from burn_raymarching_tpu_torch.ops.cuda import culled_march_kernel as k3
    from burn_raymarching_tpu_torch.render.culled import (
        culled_march_normals_xla,
    )

    rows = []
    _, mask, c, r = cs.knot_cloud(torch, dev, cs.C4_INIT_N)
    args, stats = cs.c4_tiles(torch, dev, c, r, mask)
    t_init = None
    for label, steps in (("cold", 40), ("warm16", 16)):
        res, t_p = measure(torch, cs, k3.culled_march_normals,
                           culled_march_normals_xla, (*args, cs.C4_K),
                           dict(num_steps=steps, t_init=t_init))
        rows.append({"kernel": "K3", "case": f"{label} K={cs.C4_BUDGET}",
                     **stats, **res, **tag})
        t_init = (t_p * 0.8).contiguous()

    ch_args = cs.chunked_tiles(torch, dev, args[0], args[1])
    res, _ = measure(torch, cs, k3.culled_march_normals,
                     culled_march_normals_xla, (*ch_args, cs.C4_K),
                     dict(num_steps=16))
    rows.append({"kernel": "K3",
                 "case": f"chunked warm-length K={cs.CHUNKED_K}",
                 **res, **tag})
    # The resident kernel without tile imbalance: every tile marches the
    # same 2,048 live columns (config 4's budget, all slots live).
    n_tiles = args[0].shape[0]
    full = [x[:1, :cs.C4_BUDGET].expand(
        n_tiles, cs.C4_BUDGET, *x.shape[2:]).contiguous()
        for x in ch_args[2:]]
    res, _ = measure(torch, cs, k3.culled_march_normals,
                     culled_march_normals_xla,
                     (args[0], args[1], *full, cs.C4_K),
                     dict(num_steps=16, t_init=t_init))
    rows.append({"kernel": "K3",
                 "case": f"warm16 K={cs.C4_BUDGET} all slots live",
                 **res, **tag})
    return rows


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="tree whose package is timed (default: this one)")
    ap.add_argument("--out", default="", help="append the lines to this file")
    ap.add_argument("--only", default="K1,K2,K3,K4",
                    help="kernels to time, comma-separated")
    args = ap.parse_args(argv)
    lines = [json.dumps(row) for row in run(os.path.abspath(args.root),
                                            tuple(args.only.split(",")))]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

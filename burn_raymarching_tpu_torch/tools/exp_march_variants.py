"""March-kernel micro-variant sweep (port of scripts/exp_march_variants.py).

K5 (csrc/march_variants.cu through ``ops/cuda/march_variants_kernel
.variant_march``) on the script's scene and rays: 100 spheres (centers
N(0, 0.3), raw radii N(-2, 0.3), numpy seed 0) padded to 128 slots and
activated, k = 18.5, the 128² camera from (0, 0.5, -2.5) at 50°: 16,384
rays. Masked slots carry c_sq = 1e30; the ``coord`` variants read the
centers instead, so theirs sit at 1e15. Three tables:

  1. the base variant against the port's plain march (ops/march.march, the
     reattach through ops/sdf.scene_sdf, ops/sdf.scene_normal), as the
     script's check holds it against march_xla: max |dt| and |dn| over all
     rays and over the rays that hit (t < 10);
  2. each other variant's deviation from base at 40 steps: p50 / p99 /
     max of |dt| and p99 / max of the normals' |dn|;
  3. the device time of one 16-step march + normals for each variant and
     ``tile_n`` (TILES, those that divide the rays), read as 100 chained
     launches replayed from one captured CUDA graph (the script's lax.scan
     of 100), best of ``--reps``, with the card's name and power limit on
     every line.

Tables 1 and 2 run ``tile_n`` = 1,024, as the script's do (fewer when that
does not divide the rays).

K5 is K1's march (its ``base`` gives K1's bits on K1's table), so the
variants read as deltas on the shipped kernel, as the script's did on the
TPU: base, exp2 (log2(e) folded into the scale: the per-pair exp loses its
multiply), coord and exp2+coord, as the script times them, and the four
clamp variants beside them (the script's note: wrong on far rays, whose
sum underflows to the 1e-8 floor). ``tile_n`` was the TPU grid's step; the
CUDA launch covers all rays with K1's blocks whatever it is, so table 3's
columns differ by the timing's noise alone.

Usage (the card):
  python -m burn_raymarching_tpu_torch.tools.exp_march_variants [--out FILE]
On the CPU (``--device cpu --size 16``) it runs the plain version at the
size it is given, and prints "not measured" for the times.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from burn_raymarching_tpu_torch.ops.cuda.march_variants_kernel import (
    variant_march,
)

K = 18.5
# name → (clamp, exp2, coord)
VARIANTS = {
    "base": (False, False, False),
    "exp2": (False, True, False),
    "coord": (False, False, True),
    "exp2+coord": (False, True, True),
    "clamp": (True, False, False),
    "clamp+exp2": (True, True, False),
    "clamp+coord": (True, False, True),
    "clamp+exp2+coord": (True, True, True),
}
TILES = (64, 128, 256, 512, 1024, 2048, 4096)
# The script's: steps of tables 1-2, of the timed march, chained launches
# a timing, and rays a block of tables 1-2.
STEPS, TIME_STEPS, CHAIN, CHECK_TILE = 40, 16, 100, 1024


def make_inputs(size: int, device, slots: int = 128, live: int = 100
                ) -> dict:
    """The script's scene, rays and tables (scripts/exp_march_variants.py
    :164-199) on ``device``; ``size``² rays."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays
    from burn_raymarching_tpu_torch.models.scene import (
        activate,
        init_scene_params,
        pad_params,
    )

    rng = np.random.default_rng(0)
    params = init_scene_params(live, device=device)
    with torch.no_grad():
        params.centers.copy_(torch.as_tensor(rng.normal(0, 0.3, (live, 3))))
        params.radii.copy_(torch.as_tensor(rng.normal(-2.0, 0.3, (live, 1))))
        padded, mask = pad_params(params, slots)
        centers, _, radii, _, _ = (x.detach() for x in activate(padded))
    ro, rd = create_camera_rays(size, size, [0.0, 0.5, -2.5], [0, 0, 0],
                                50.0, device=device)
    r = radii.reshape(-1)
    c_sq = torch.where(mask[None, :], torch.sum(centers * centers, dim=1)
                       [None, :], 1e30)
    c_far = torch.where(mask[:, None], centers, 1e15)
    return {"ro": ro, "rd": rd, "centers": centers, "radii": radii,
            "mask": mask,
            "prim": torch.cat([centers.T, r[None, :]]).contiguous(),
            "prim_far": torch.cat([c_far.T, r[None, :]]).contiguous(),
            "c_sq": c_sq.contiguous(),
            "k_arr": torch.full((1, 1), K, dtype=torch.float32,
                                device=device),
            "t0": torch.zeros((ro.shape[0], 1), dtype=torch.float32,
                              device=device)}


def run_variant(inp: dict, name: str, num_steps: int, tile_n: int):
    """One variant of K5 on the inputs → (t [N, 1], normal [N, 3])."""
    clamp, exp2, coord = VARIANTS[name]
    prim = inp["prim_far"] if coord else inp["prim"]
    return variant_march(inp["ro"], inp["rd"], inp["t0"], prim, inp["c_sq"],
                         inp["k_arr"], num_steps, tile_n, clamp, exp2, coord)


@torch.no_grad()
def reference(inp: dict, num_steps: int):
    """The port's plain march, reattach and normals (the script's
    march_xla + scene_sdf + scene_normal, :169-176)."""
    from burn_raymarching_tpu_torch.ops.march import march
    from burn_raymarching_tpu_torch.ops.sdf import scene_normal, scene_sdf

    ro, rd, c, r, mask = (inp[key] for key in ("ro", "rd", "centers",
                                                "radii", "mask"))
    t = march(ro, rd, c, r, K, mask=mask, num_steps=num_steps)
    d_last = scene_sdf(ro + rd * t, c, r, K, mask=mask)
    p_final = ro + rd * (t + d_last)
    return t, scene_normal(p_final, c, r, K, mask=mask)


def _gaps(t, n, t_ref, n_ref) -> dict:
    dt = (t - t_ref).abs()[:, 0].double().cpu().numpy()
    dn = (n - n_ref).abs().amax(dim=1).double().cpu().numpy()
    hit = (t_ref[:, 0] < 10.0).cpu().numpy()
    return {"max_dt": float(dt.max()), "max_dn": float(dn.max()),
            "max_dt_hit": float(dt[hit].max()) if hit.any() else 0.0,
            "max_dn_hit": float(dn[hit].max()) if hit.any() else 0.0,
            "hit_rays": int(hit.sum()),
            "p50_dt": float(np.percentile(dt, 50)),
            "p99_dt": float(np.percentile(dt, 99)),
            "p99_dn": float(np.percentile(dn, 99))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=128,
                    help="camera side: size² rays (the script's 128)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed replays of each chain; the best is kept")
    ap.add_argument("--out", default=None, help="write the results (JSON)")
    args = ap.parse_args(argv)

    from burn_raymarching_tpu_torch.tools.bench_large import card
    from burn_raymarching_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    where = card() if on_card else "cpu: not a device time"
    inp = make_inputs(args.size, dev)
    n = inp["ro"].shape[0]
    check_tile = math.gcd(n, CHECK_TILE)
    out = {"card": where, "rays": n, "slots": inp["prim"].shape[1],
           "steps": STEPS, "check_tile": check_tile}

    t_ref, n_ref = reference(inp, STEPS)
    t_base, n_base = run_variant(inp, "base", STEPS, check_tile)
    out["base_vs_plain_march"] = _gaps(t_base, n_base, t_ref, n_ref)
    g = out["base_vs_plain_march"]
    print(f"base kernel vs the plain march ({n} rays, M={out['slots']}, "
          f"{STEPS} steps, tile={check_tile}): max|dt|="
          f"{g['max_dt']:.2e} max|dn|={g['max_dn']:.2e}; on the "
          f"{g['hit_rays']} hit rays max|dt|={g['max_dt_hit']:.2e} "
          f"max|dn|={g['max_dn_hit']:.2e}", flush=True)

    print(f"deviation vs base kernel ({n} rays, M={out['slots']}, "
          f"{STEPS} steps):", flush=True)
    out["deviation"] = {}
    for name in VARIANTS:
        if name == "base":
            continue
        t, nrm = run_variant(inp, name, STEPS, check_tile)
        d = out["deviation"][name] = _gaps(t, nrm, t_base, n_base)
        print(f"  {name:<18} |dt| p50={d['p50_dt']:.1e} "
              f"p99={d['p99_dt']:.1e} max={d['max_dt']:.1e}  |dn| "
              f"p99={d['p99_dn']:.1e} max={d['max_dn']:.1e}", flush=True)

    from burn_raymarching_tpu_torch.tools.device_time import chained_ms

    print(f"\ntimings (ms per {TIME_STEPS}-step march+normals, {n} "
          f"rays, M={out['slots']}, {CHAIN} chained launches from one "
          f"CUDA graph, best of {args.reps}; {where}):", flush=True)
    out["ms"] = {}
    for name in VARIANTS:
        out["ms"][name] = {}
        for tile in TILES:
            if n % tile:
                print(f"  {name:<18} tile={tile:<5} does not divide {n} "
                      f"rays: skipped", flush=True)
                continue
            ms = None
            if on_card:
                ms = chained_ms(lambda: run_variant(
                    inp, name, TIME_STEPS, tile), CHAIN, reps=args.reps)
            out["ms"][name][tile] = ms
            shown = f"{ms:8.4f} ms" if ms is not None else "not measured"
            print(f"  {name:<18} tile={tile:<5} {shown}  [{where}]",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

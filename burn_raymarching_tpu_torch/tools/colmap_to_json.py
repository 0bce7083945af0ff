"""COLMAP sparse TXT model → cameras.json
(port of burn_raymarching_tpu/tools/colmap_to_json.py).

Equivalent of the reference's colmap_to_json.ts: parses cameras.txt for
per-camera FOV (2*atan(h/2f)) and images.txt for poses; camera center is
-Rᵀt, look direction Rᵀ[0,0,1], target = origin + look.

Usage: python -m burn_raymarching_tpu_torch.tools.colmap_to_json
           [--colmap data/tomato/sparse/0] [--out data/cameras.json]
           [--prefix data/tomato/images_nobg/]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def qvec2rotmat(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Quaternion → 3x3 rotation (colmap_to_json.ts:7-13)."""
    return np.array([
        [1 - 2 * qy ** 2 - 2 * qz ** 2, 2 * qx * qy - 2 * qw * qz,
         2 * qx * qz + 2 * qw * qy],
        [2 * qx * qy + 2 * qw * qz, 1 - 2 * qx ** 2 - 2 * qz ** 2,
         2 * qy * qz - 2 * qw * qx],
        [2 * qx * qz - 2 * qw * qy, 2 * qy * qz + 2 * qw * qx,
         1 - 2 * qx ** 2 - 2 * qy ** 2],
    ])


def parse_cameras_txt(text: str) -> dict[int, float]:
    """cameras.txt → {camera_id: fov_y degrees} (colmap_to_json.ts:39-52)."""
    fov = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        elems = line.split(" ")
        cam_id = int(elems[0])
        height = float(elems[3])
        focal = float(elems[4])
        fov[cam_id] = math.degrees(2.0 * math.atan(height / (2.0 * focal)))
    return fov


def parse_images_txt(text: str, fov: dict[int, float],
                     prefix: str) -> list[dict]:
    """images.txt (2 lines per image) → camera configs
    (colmap_to_json.ts:55-97)."""
    configs = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line.startswith("#") or not line:
            continue
        elems = line.split(" ")
        qw, qx, qy, qz = (float(e) for e in elems[1:5])
        t = np.array([float(e) for e in elems[5:8]])
        cam_id = int(elems[8])
        name = elems[9]
        i += 1  # skip the 2D-points line

        r_t = qvec2rotmat(qw, qx, qy, qz).T
        origin = -(r_t @ t)
        look = r_t @ np.array([0.0, 0.0, 1.0])
        configs.append({
            "file": prefix + name,
            "origin": origin.tolist(),
            "target": (origin + look).tolist(),
            "fov": fov[cam_id],
        })
    return configs


def parse_points3d_txt(text: str) -> np.ndarray:
    """points3D.txt → [N, 3] sparse SfM points.

    These are the 3DGS-style geometry prior for dense-cloud initialization
    (config init_points) — the COLMAP analog of initializing Gaussians from
    the SfM point cloud. The TS reference tooling ignores this file; large
    from-scratch clouds don't contract without a prior.
    """
    pts = []
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        elems = line.split(" ")
        pts.append([float(elems[1]), float(elems[2]), float(elems[3])])
    return np.asarray(pts, np.float32).reshape(-1, 3)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--colmap", default="data/tomato/sparse/0")
    parser.add_argument("--out", default="data/cameras.json")
    parser.add_argument("--prefix", default="data/tomato/images_nobg/")
    parser.add_argument("--points-out", dest="points_out", default=None,
                        help="also write points3D.txt as a JSON point list "
                             "(init prior for large-scene training)")
    args = parser.parse_args(argv)

    with open(os.path.join(args.colmap, "cameras.txt")) as f:
        fov = parse_cameras_txt(f.read())
    with open(os.path.join(args.colmap, "images.txt")) as f:
        configs = parse_images_txt(f.read(), fov, args.prefix)

    from burn_raymarching_tpu_torch.data.scene_io import save_cameras

    save_cameras(configs, args.out)
    print(f"✅ Generated {len(configs)} camera configs to {args.out}")

    if args.points_out:
        import json

        with open(os.path.join(args.colmap, "points3D.txt")) as f:
            pts = parse_points3d_txt(f.read())
        with open(args.points_out, "w") as f:
            json.dump({"points": pts.reshape(-1).tolist()}, f)
        print(f"✅ Wrote {pts.shape[0]} sparse points to {args.points_out}")


if __name__ == "__main__":
    main()

"""Offline scene viewer — batch novel-view renderer for scene.json (port of
burn_raymarching_tpu/tools/viewer_offline.py).

Renders orbit frames (or a single pose) to PNGs / an MP4 from a scene.json,
the reference viewer's format, with one of two shading models:
  --model train  — the differentiable renderer's forward (softmax composite,
                   sigmoid coverage): what training optimized. On a GPU its
                   march and normals are the K1 kernel
                   (ops/cuda/march_shade_kernel.py), as in training.
  --model viewer — the reference viewer's shading, WGSL-exact
                   (shader.wgsl:43-128): hard hit test (march with
                   epsilon/t_max), TETRAHEDRAL 4-tap normals, exp-weight
                   colors normalized by sum, black background. Plain
                   PyTorch (the JAX package computes it with XLA, no
                   kernel).

Both models render ``chunk`` rays at a time, which bounds the [chunk, M]
(train) and [chunk, M, 3] (viewer) working sets; rays are independent.

Usage:
  python -m burn_raymarching_tpu_torch.tools.viewer_offline scene.json
      [--out orbit] [--frames 60] [--size 512] [--radius 2.5] [--height 0.5]
      [--model viewer|train] [--video orbit.mp4] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import march_shade
from burn_raymarching_tpu_torch.utils.device import resolve_device
from burn_raymarching_tpu_torch.utils.profiling import annotate

# The smooth-min sharpness both models render with (the viewer shader's
# k = 32, shader.wgsl:43-61).
VIEW_K = 32.0


def scene_tensors(scene: dict, device) -> tuple:
    """(centers, colors, radii, light_dir, ambient) of a loaded scene.json as
    float32 tensors on ``device``."""
    return tuple(torch.as_tensor(scene[key], dtype=torch.float32,
                                 device=device)
                 for key in ("centers", "colors", "radii", "light_dir",
                             "ambient_intensity"))


@torch.no_grad()
def train_shade(ro, rd, centers, colors, radii, light_dir, ambient,
                chunk: int = 16384, march_normal_fn=march_shade):
    """The training forward (render/diff.render_diff at k = 32) over
    ``chunk`` rays at a time → [N, 3]. ``march_normal_fn`` is the K1 wrapper
    (its plain version for CPU tensors); None marches with the plain march
    and normals of render_diff, the reference the viewer tests hold K1's
    frames against."""
    from burn_raymarching_tpu_torch.render.diff import render_diff

    return torch.cat([
        render_diff(ro[i:i + chunk], rd[i:i + chunk], centers, colors, radii,
                    light_dir, ambient, VIEW_K,
                    march_normal_fn=march_normal_fn)
        for i in range(0, ro.shape[0], chunk)])


def render_pose(scene, eye, target, size, model="viewer", fov=50.0,
                chunk=16384, device="cuda") -> np.ndarray:
    """One size x size frame of ``scene`` (a loaded scene.json) from ``eye``
    looking at ``target`` → [size², 3] linear RGB (numpy float32). Its
    spans: ``view.scene_upload``, ``view.rays``, ``view.render`` (the
    host's enqueue of the march and the tail) and ``view.readback`` (where
    the host waits for the card)."""
    from burn_raymarching_tpu_torch.data.camera import create_camera_rays

    dev = resolve_device(device)
    if model not in ("train", "viewer"):
        raise ValueError(f"unknown model {model!r} (viewer or train)")
    with annotate("view.scene_upload"):
        params = scene_tensors(scene, dev)
    with annotate("view.rays"):
        ro, rd = create_camera_rays(size, size, eye, target, fov, device=dev)
    with annotate("view.render"):
        if model == "train":
            img = train_shade(ro, rd, *params, chunk=chunk)
        else:
            img = torch.cat([
                _viewer_shade(ro[i:i + chunk], rd[i:i + chunk], *params)
                for i in range(0, ro.shape[0], chunk)])
    with annotate("view.readback"):
        return img.cpu().numpy()


def _map_wgsl(p, centers, radii):
    """[N, 3] → [N] scene distance: the shader's pairwise smin_exp fold at
    k = 32 (shader.wgsl:43-61) ≡ −log Σ e^{−32 d} / 32, max-subtracted, over
    the direct distances |p − c| − r."""
    diff = p[:, None, :] - centers[None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=2)) - radii.reshape(1, -1)
    val = d * -VIEW_K
    mx = torch.amax(val, dim=1, keepdim=True)
    return -(torch.log(torch.sum(torch.exp(val - mx), dim=1))
             + mx[:, 0]) / VIEW_K


@torch.no_grad()
def _viewer_shade(ro, rd, centers, colors, radii, light_dir, ambient):
    """The viewer shader's forward model, WGSL-exact (shader.wgsl:43-128),
    in the dtype of its inputs:

      * map(): pairwise smin_exp fold at k=32 (:43-61) ≡ one LogSumExp over
        all spheres — computed max-subtracted here (identical math; the
        shader's raw exp sum underflows past d ≈ 2.7 to d=+inf, which only
        fast-forwards rays that have already missed — final pixels agree);
        direct length(p−c)−r distances, NO training-path epsilons;
      * 100-step march, hit ε = 0.001 tested before the step, t_max = 20
        (:102-108);
      * TETRAHEDRAL 4-tap normals, eps 0.001, plain normalize (:63-72) —
        not the training renderer's 6-tap central differences;
      * calc_color: exp(−10·d) weights normalized by (sum + 1e-5) (:74-86);
      * ambient + diffuse·(1−ambient) blend (:117-124), black miss (:111).
    """
    t = torch.zeros((ro.shape[0], 1), dtype=ro.dtype, device=ro.device)
    hit = torch.zeros((ro.shape[0],), dtype=torch.bool, device=ro.device)
    for _ in range(100):
        d = _map_wgsl(ro + rd * t, centers, radii)[:, None]
        hit = hit | (d[:, 0] < 0.001)
        t = t + torch.where((hit | (t[:, 0] > 20.0))[:, None],
                            torch.zeros_like(d), d)

    p = ro + rd * t
    # Tetrahedral 4-tap normals (shader.wgsl:63-72): k=(1,-1), eps 1e-3.
    eps = 0.001
    taps = torch.tensor([[1.0, -1.0, -1.0], [-1.0, -1.0, 1.0],
                         [-1.0, 1.0, -1.0], [1.0, 1.0, 1.0]],
                        dtype=ro.dtype, device=ro.device)
    n_raw = sum(taps[i] * _map_wgsl(p + taps[i] * eps, centers,
                                    radii)[:, None]
                for i in range(4))
    normal = n_raw / torch.clamp(
        torch.sqrt(torch.sum(n_raw * n_raw, dim=1, keepdim=True)), min=1e-20)
    ld = light_dir / torch.sqrt(torch.sum(light_dir * light_dir))
    diffuse = torch.clamp(torch.sum(normal * ld[None, :], dim=1,
                                    keepdim=True), min=0.0)
    dd = p[:, None, :] - centers[None, :, :]
    dists = torch.sqrt(torch.sum(dd * dd, dim=2)) - radii.reshape(1, -1)
    w = torch.exp(dists * -10.0)
    color = (w @ colors) / (torch.sum(w, dim=1, keepdim=True) + 1e-5)
    lighting = ambient + diffuse * (1.0 - ambient)
    out = color * lighting
    return torch.where(hit[:, None], out, torch.zeros_like(out))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("scene", nargs="?", default="scene.json")
    parser.add_argument("--out", default="orbit")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--radius", type=float, default=2.5)
    parser.add_argument("--height", type=float, default=0.5)
    parser.add_argument("--fov", type=float, default=50.0)
    parser.add_argument("--model", choices=("viewer", "train"),
                        default="viewer")
    parser.add_argument("--video", default=None,
                        help="also write an MP4 (requires imageio/ffmpeg)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; a missing card "
                             "raises)")
    args = parser.parse_args(argv)

    from burn_raymarching_tpu_torch.data.image_io import (
        read_png,
        save_array_as_image,
    )
    from burn_raymarching_tpu_torch.data.scene_io import load_scene_json

    dev = resolve_device(args.device)
    iio = None
    if args.video:
        try:
            import imageio.v3 as iio
        except ImportError as err:
            raise SystemExit("--video needs the imageio package (with its "
                             "ffmpeg plugin); install it or drop --video"
                             ) from err

    scene = load_scene_json(args.scene)
    print(f"Loaded {scene['num_spheres']} spheres from {args.scene}")
    os.makedirs(args.out, exist_ok=True)
    frames = []
    for i in range(args.frames):
        angle = i * 2.0 * math.pi / args.frames
        eye = [args.radius * math.cos(angle), args.height,
               args.radius * math.sin(angle)]
        img = render_pose(scene, eye, [0.0, 0.0, 0.0], args.size,
                          model=args.model, fov=args.fov, device=dev)
        path = os.path.join(args.out, f"frame_{i:04d}.png")
        save_array_as_image(img, args.size, args.size, path)
        frames.append(path)
    print(f"Wrote {len(frames)} frames to {args.out}/")

    if iio is not None:
        stack = np.stack([read_png(f) for f in frames])
        iio.imwrite(args.video, stack, fps=30)
        print(f"Wrote {args.video}")


if __name__ == "__main__":
    main()

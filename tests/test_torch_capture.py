"""The port's capture tools against the JAX package's, on the synthetic
COLMAP capture of tests/test_capture_pipeline.py: reddish renders of a
3-sphere scene from an 8-camera orbit plus one broken outlier pose, written
as a COLMAP sparse TXT model. Each tool's files must be byte-identical to
its JAX twin's on the same inputs (chromakey: equal arrays), and the chain's
output then trains with the port's train_cli on the CPU."""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_capture_pipeline import look_rotation, rotmat2qvec

from burn_raymarching_tpu.tools import chromakey as j_chromakey
from burn_raymarching_tpu.tools import colmap_to_json as j_colmap
from burn_raymarching_tpu.tools import generate_perfect_cameras as j_perfect
from burn_raymarching_tpu.tools import process_cameras as j_process
from burn_raymarching_tpu_torch.data.camera import create_camera_rays
from burn_raymarching_tpu_torch.data.image_io import save_array_as_image
from burn_raymarching_tpu_torch.render.gt import render_gt
from burn_raymarching_tpu_torch.tools import (
    chromakey,
    colmap_to_json,
    generate_perfect_cameras,
    process_cameras,
    train_cli,
)

SIZE = 256
FOV = 50.0


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """tests/test_capture_pipeline.py's capture, rendered with the port."""
    root = tmp_path_factory.mktemp("capture")
    img_dir = root / "images"
    img_dir.mkdir()
    centers = torch.tensor([[-0.3, 0.0, 0.0], [0.0, 0.0, 0.0],
                            [0.3, 0.0, 0.0]])
    colors = torch.tensor([[0.95, 0.15, 0.1], [0.85, 0.35, 0.15],
                           [0.9, 0.2, 0.3]])
    radii = torch.tensor([[0.2], [0.15], [0.2]])
    rig = []
    for i in range(8):
        a = i * 2 * math.pi / 8
        rig.append(([2.5 * math.cos(a), 0.5, 2.5 * math.sin(a)],
                    [0.0, 0.0, 0.0]))
    for i, (origin, target) in enumerate(rig):
        ro, rd = create_camera_rays(SIZE, SIZE, origin, target, FOV,
                                    device="cpu")
        img = render_gt(ro, rd, centers, colors, radii)
        save_array_as_image(img.numpy(), SIZE, SIZE,
                            str(img_dir / f"f{i:03d}.png"))

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    focal = SIZE / (2.0 * math.tan(math.radians(FOV / 2)))
    (sparse / "cameras.txt").write_text(
        "# Camera list\n"
        f"1 PINHOLE {SIZE} {SIZE} {focal:.6f} {focal:.6f} "
        f"{SIZE / 2} {SIZE / 2}\n")
    lines = ["# Image list"]
    poses = rig + [([20.0, 3.0, 5.0], [25.0, 3.0, 5.0])]
    save_array_as_image(np.zeros((SIZE * SIZE, 3), np.float32), SIZE, SIZE,
                        str(img_dir / f"f{len(rig):03d}.png"))
    for i, (origin, target) in enumerate(poses):
        R = look_rotation(origin, target)
        q = rotmat2qvec(R)
        t = -R @ np.asarray(origin, np.float64)
        lines.append(
            f"{i + 1} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
            f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} 1 f{i:03d}.png")
        lines.append("")
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")

    rng = np.random.default_rng(0)
    base = np.repeat(centers.numpy(), 40, axis=0)
    pts = base + rng.normal(0, 0.05, base.shape)
    plines = ["# 3D point list"]
    for i, p in enumerate(pts):
        plines.append(f"{i + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                      "200 40 40 0.5 1 0")
    (sparse / "points3D.txt").write_text("\n".join(plines) + "\n")
    return root


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_chromakey_matches_jax(capture, tmp_path):
    for name in ("f000.png", "f003.png", "f008.png"):
        img = Image.open(capture / "images" / name)
        for kw in ({}, {"min_brightness": 60.0, "red_margin": 10.0}):
            want = j_chromakey.chromakey_image(img, **kw)
            got = chromakey.chromakey_image(img, **kw)
            assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
            assert np.array_equal(got, want)
    argv = ["--in", str(capture / "images"), "--ext", "png",
            "--min-brightness", "60"]
    chromakey.main(argv + ["--out", str(tmp_path / "port")])
    j_chromakey.main(argv + ["--out", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 9
    for name in names:
        a = np.asarray(Image.open(tmp_path / "port" / name))
        b = np.asarray(Image.open(tmp_path / "jax" / name))
        assert np.array_equal(a, b)
    sample = np.asarray(Image.open(tmp_path / "port" / "f000.png"))
    assert sample[:40, :40].sum() == 0 and sample.sum() > 0


def test_colmap_to_json_matches_jax(capture, tmp_path):
    outs = {}
    for tag, tool in (("port", colmap_to_json), ("jax", j_colmap)):
        cams, pts = tmp_path / f"{tag}_cams.json", tmp_path / f"{tag}_p.json"
        tool.main(["--colmap", str(capture / "sparse" / "0"), "--out",
                   str(cams), "--prefix", "images_nobg/",
                   "--points-out", str(pts)])
        outs[tag] = (read_bytes(cams), read_bytes(pts))
    assert outs["port"] == outs["jax"]
    cams = json.loads(outs["port"][0])
    assert len(cams) == 9
    np.testing.assert_allclose(cams[0]["fov"], FOV, rtol=1e-6)
    assert len(json.loads(outs["port"][1])["points"]) == 120 * 3


@pytest.mark.parametrize("interval,threshold,scale", [(1, 1.5, 1.0),
                                                      (2, 1.5, 0.5)])
def test_process_cameras_matches_jax(capture, tmp_path, interval, threshold,
                                     scale):
    raw, pts = tmp_path / "raw.json", tmp_path / "pts.json"
    j_colmap.main(["--colmap", str(capture / "sparse" / "0"), "--out",
                   str(raw), "--prefix", f"{capture / 'images'}/",
                   "--points-out", str(pts)])
    outs = {}
    for tag, tool in (("port", process_cameras), ("jax", j_process)):
        cams, p_out = tmp_path / f"{tag}_c.json", tmp_path / f"{tag}_p.json"
        tool.main(["--in", str(raw), "--out", str(cams), "--interval",
                   str(interval), "--threshold", str(threshold), "--scale",
                   str(scale), "--points-in", str(pts), "--points-out",
                   str(p_out)])
        outs[tag] = (read_bytes(cams), read_bytes(p_out))
    assert outs["port"] == outs["jax"]
    assert len(json.loads(outs["port"][0])) == (8 if interval == 1 else 4)
    with pytest.raises(SystemExit, match="--points-out"):
        process_cameras.main(["--in", str(raw), "--out",
                              str(tmp_path / "x.json"), "--points-in",
                              str(pts)])


def test_generate_perfect_cameras_matches_jax(capture, tmp_path):
    outs = {}
    for tag, tool in (("port", generate_perfect_cameras), ("jax", j_perfect)):
        out = tmp_path / f"{tag}.json"
        tool.main(["--images", str(capture / "images"), "--ext", "png",
                   "--interval", "2", "--out", str(out), "--radius", "2.2"])
        outs[tag] = read_bytes(out)
    assert outs["port"] == outs["jax"]
    assert len(json.loads(outs["port"])) == 5


def test_capture_chain_trains_with_the_port(capture, tmp_path, monkeypatch):
    """chromakey → colmap_to_json → process_cameras with the port's tools,
    then a few steps of the port's train_cli on the CPU from the recentred
    sparse prior."""
    monkeypatch.chdir(tmp_path)
    chromakey.main(["--in", str(capture / "images"), "--out", "images_nobg",
                    "--ext", "png", "--min-brightness", "60"])
    colmap_to_json.main(["--colmap", str(capture / "sparse" / "0"),
                         "--out", "cameras_raw.json", "--prefix",
                         "images_nobg/", "--points-out", "points_raw.json"])
    process_cameras.main(["--in", "cameras_raw.json", "--out",
                          "cameras.json", "--interval", "1",
                          "--points-in", "points_raw.json",
                          "--points-out", "points.json"])
    assert len(json.load(open("cameras.json"))) == 8   # outlier rejected
    trainer, padded, mask = train_cli.main([
        "--cameras", "cameras.json", "--width", "256", "--height", "256",
        "--stages", "1", "--steps", "4", "--batch", "512", "--init-n", "32",
        "--init-layout", "cloud", "--init-points", "points.json",
        "--scene-out", "scene_capture.json", "--device", "cpu"])
    assert len(trainer.loss_history) > 0
    assert all(np.isfinite(trainer.loss_history))
    scene = json.load(open("scene_capture.json"))
    assert scene["num_spheres"] == int(mask.sum())
    assert np.isfinite(scene["centers"]).all()

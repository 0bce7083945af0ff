"""The port's offline viewer (tools/viewer_offline.py) against the JAX
package's, on the same numpy inputs.

Frames are compared as the viewer writes them, uint8 after the gamma: mean
|Δ| < 0.05 LSB and at most 0.2% of pixels off by more than 2 LSB (the
bounds of the viewer's golden test, tests/test_viewer_shader.py), and the
hit masks (lit pixels) agree on at least 99.5% of the pixels. The scene is
the tracked config-4 headline scene (1,340 spheres) at 48² from the default
orbit pose, where about a quarter of the pixels hit, and a small seeded one.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device, nn, tt  # noqa: F401  (fixture)

from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.tools import viewer_offline as jview
from burn_raymarching_tpu_torch.data.image_io import read_png
from burn_raymarching_tpu_torch.data.scene_io import load_scene_json
from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
from burn_raymarching_tpu_torch.tools import kernel_cases as kc
from burn_raymarching_tpu_torch.tools import viewer_offline as view

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C4_SCENE = os.path.join(ROOT, "runs", "c4_headline", "scene_c5.json")
C5_SCENE = os.path.join(ROOT, "runs", "c5_headline", "scene_c5.json")
EYE = [2.5, 0.5, 0.0]
KEYS = ("centers", "colors", "radii", "light_dir", "ambient_intensity")


def u8(img) -> np.ndarray:
    return (np.clip(np.asarray(img), 0, 1) ** (1 / 2.2) * 255).astype(
        np.int32)


def assert_frames_agree(got, want):
    gaps = kc.u8_gaps(got, want)
    assert gaps["mean_lsb"] < 0.05, gaps
    assert gaps["share_over_2_lsb"] < 0.002, gaps
    assert gaps["lit_mismatch_share"] <= 0.005, gaps
    return (np.asarray(want).reshape(-1, 3).sum(1) > 0).mean()


@pytest.fixture(scope="module")
def c4_scene():
    return load_scene_json(C4_SCENE)


def seeded_scene(m: int = 40, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "num_spheres": m,
        "centers": rng.normal(0, 0.3, (m, 3)).astype(np.float32),
        "colors": rng.uniform(0, 1, (m, 3)).astype(np.float32),
        "radii": rng.uniform(0.05, 0.15, (m, 1)).astype(np.float32),
        "light_dir": rng.normal(0, 1, 3).astype(np.float32),
        "ambient_intensity": np.asarray([0.2], np.float32),
    }


def shade_both(scene, size, eye, target=(0.0, 0.0, 0.0), fov=50.0):
    ro, rd = j_rays(size, size, eye, list(target), fov)
    want = jview._viewer_shade(ro, rd, *(jnp.asarray(scene[k])
                                         for k in KEYS))
    got = view._viewer_shade(tt(ro), tt(rd), *(tt(scene[k]) for k in KEYS))
    return nn(got), np.asarray(want)


@pytest.mark.parametrize("which", ["c4_headline", "seeded"])
def test_viewer_shade_matches_jax(which, c4_scene):
    scene = c4_scene if which == "c4_headline" else seeded_scene()
    size, eye = (48, EYE) if which == "c4_headline" else (32,
                                                         [0.0, 0.5, -2.5])
    got, want = shade_both(scene, size, eye)
    lit = assert_frames_agree(got, want)
    assert 0.1 < lit < 0.9, lit
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_viewer_normals_are_tetrahedral():
    """tests/test_viewer_shader.py's case: a lone sphere lit head-on along
    −z with no ambient reads ~1 in red at its centre pixel (the 4-tap
    normal reproduces the analytic one to O(eps)); the miss is black."""
    scene = {"centers": np.asarray([[0.2, 0.1, 0.0]], np.float32),
             "colors": np.asarray([[1.0, 0.0, 0.0]], np.float32),
             "radii": np.asarray([[0.3]], np.float32),
             "light_dir": np.asarray([0.0, 0.0, -1.0], np.float32),
             "ambient_intensity": np.asarray([0.0], np.float32)}
    got, want = shade_both(scene, 16, [0.2, 0.1, -2.0], (0.2, 0.1, 0.0),
                           fov=40.0)
    img = got.reshape(16, 16, 3)
    c = img[8, 8]
    assert c[0] == pytest.approx(1.0, abs=0.02), c
    assert c[1] == 0.0 and c[2] == 0.0
    assert img[0, 0].sum() == 0.0
    # The 4-tap difference over 2 eps = 2e-3 lifts the map's float32
    # rounding (~6e-8 at |d| ~ 1) to ~3e-5 in the normal.
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_viewer_map_is_pairwise_smin_exp():
    """tests/test_viewer_shader.py's case: two overlapping spheres, one ray
    through both; and map() itself against −log Σ e^{−32 d} / 32 over the
    direct distances, in float64."""
    centers = np.asarray([[0.05, 0.0, 0.0], [-0.05, 0.0, 0.0]], np.float32)
    radii = np.asarray([[0.2], [0.2]], np.float32)
    img = view._viewer_shade(
        torch.tensor([[0.0, 0.0, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]]),
        tt(centers), torch.ones(2, 3) * 0.5, tt(radii),
        torch.tensor([0.0, 0.0, -1.0]), torch.tensor([0.5]))
    assert torch.isfinite(img).all() and img.max() > 0

    p = np.random.default_rng(1).normal(0, 0.5, (64, 3))
    d = (np.linalg.norm(p[:, None, :] - centers[None].astype(np.float64),
                        axis=2) - radii[:, 0])
    want = -np.log(np.exp(-32.0 * d).sum(1)) / 32.0
    got = view._map_wgsl(torch.as_tensor(p), torch.as_tensor(
        centers, dtype=torch.float64), torch.as_tensor(radii,
                                                       dtype=torch.float64))
    np.testing.assert_allclose(nn(got), want, rtol=1e-12, atol=1e-12)
    assert (nn(got) < d.min(1)).all()


def test_render_pose_train_matches_jax(c4_scene):
    want = jview.render_pose(c4_scene, EYE, [0.0, 0.0, 0.0], 40,
                             model="train")
    got = view.render_pose(c4_scene, EYE, [0.0, 0.0, 0.0], 40,
                           model="train", device="cpu")
    assert got.shape == (1600, 3) and got.dtype == np.float32
    assert_frames_agree(got, want)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("model", ["viewer", "train"])
def test_chunked_frame_equals_unchunked(model):
    scene = seeded_scene(24, seed=3)
    kw = dict(model=model, device="cpu")
    whole = view.render_pose(scene, [0.0, 0.5, -2.5], [0, 0, 0], 24, **kw)
    chunked = view.render_pose(scene, [0.0, 0.5, -2.5], [0, 0, 0], 24,
                               chunk=100, **kw)
    assert (whole.sum(1) > 0).mean() > 0.1
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-6)


def test_main_writes_readable_frames(tmp_path):
    scene_path = tmp_path / "scene.json"
    s = seeded_scene(12, seed=5)
    scene_path.write_text(json.dumps({
        "num_spheres": 12, **{k: np.asarray(s[k]).reshape(-1).tolist()
                              for k in KEYS}}))
    out = tmp_path / "orbit"
    view.main([str(scene_path), "--out", str(out), "--frames", "3",
               "--size", "20", "--model", "train", "--device", "cpu"])
    frames = sorted(os.listdir(out))
    assert frames == [f"frame_{i:04d}.png" for i in range(3)]
    imgs = [read_png(str(out / f)) for f in frames]
    assert all(img.shape == (20, 20, 3) for img in imgs)
    assert all(img.max() > 0 for img in imgs)
    # Frame 0 is the orbit pose at angle 0: eye (radius, height, 0).
    want = view.render_pose(load_scene_json(str(scene_path)), EYE,
                            [0.0, 0.0, 0.0], 20, model="train",
                            device="cpu")
    assert np.array_equal(imgs[0].reshape(-1, 3), u8(want))


def test_main_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        view.main([C4_SCENE, "--out", str(tmp_path), "--frames", "1"])


def test_video_without_imageio_fails_clearly(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "imageio", None)
    with pytest.raises(SystemExit, match="imageio"):
        view.main([C4_SCENE, "--out", str(tmp_path), "--frames", "1",
                   "--video", str(tmp_path / "o.mp4"), "--device", "cpu"])
    assert not os.listdir(tmp_path)


@pytest.mark.cuda
def test_cuda_k1_at_the_viewer_shape(cuda_device):
    """K1 against its plain version on the viewer's path: M = 2,435 from
    the tracked c5 scene (the kernel's chunk-by-chunk branch), 64² rays from
    the default orbit pose, k = 32. t and normals at K1's fixed
    tolerances (kernel_cases.MARCH_TOLS; or 5x the plain version's own gap
    to float64 plus 1e-5, where the march is noisier); the frame within the
    uint8 bounds."""
    dev = cuda_device
    scene = load_scene_json(C5_SCENE)
    c, col, r, ld, amb = view.scene_tensors(scene, dev)
    ro, rd = (tt(x).to(dev) for x in j_rays(64, 64, EYE, [0, 0, 0], 50.0))
    before = k1.march_shade.launches
    t_k, n_k = k1.march_shade(ro, rd, c, r, view.VIEW_K)
    assert k1.march_shade.launches == before + 1
    t_p, n_p = k1.march_shade_plain(ro, rd, c, r, view.VIEW_K)
    t_64, n_64 = k1.march_shade_plain(ro.double(), rd.double(), c.double(),
                                      r.double(), view.VIEW_K)
    errs = kc.march_errors(t_k, n_k, t_p, n_p)
    assert errs["hit_rays"] > 400, errs
    noise = kc.march_noise_tols(t_p, n_p, t_64, n_64)
    tols = {key: max(tol, noise[key]) for key, tol in kc.MARCH_TOLS.items()}
    assert not kc.march_excess(errs, tols), (errs, tols)
    got = view.train_shade(ro, rd, c, col, r, ld, amb, chunk=1024)
    want = view.train_shade(ro, rd, c, col, r, ld, amb, chunk=1024,
                            march_normal_fn=None)
    assert_frames_agree(nn(got), nn(want))


@pytest.mark.cuda
def test_cuda_viewer_model_float32_frame_matches_float64(cuda_device):
    """The viewer model (the HTTP viewer's default, plain PyTorch) on the
    card: its float32 frame of the tracked c5 scene (2,435 spheres) at 128²
    from the default orbit pose against the same frame in float64, within
    the uint8 bounds."""
    scene = load_scene_json(C5_SCENE)
    params = view.scene_tensors(scene, cuda_device)
    ro, rd = (tt(x).to(cuda_device)
              for x in j_rays(128, 128, EYE, [0, 0, 0], 50.0))
    f32 = view._viewer_shade(ro, rd, *params)
    f64 = view._viewer_shade(ro.double(), rd.double(),
                             *(p.double() for p in params))
    assert assert_frames_agree(nn(f32), nn(f64)) > 0.1

"""The port's native host helpers (burn_raymarching_tpu_torch/native)
against the JAX package's density control (train/density.py) and ray
generation (data/camera.py) on the same numpy inputs: the cases of
tests/test_native.py, and the copied C++ source held byte-equal to the
repository's native/ original."""

import dataclasses
import os

import numpy as np
import pytest

from burn_raymarching_tpu.config import DensityConfig as JaxDensityConfig
from burn_raymarching_tpu.data.camera import (
    create_camera_rays as jax_camera_rays,
)
from burn_raymarching_tpu.train.density import (
    prune_and_split as jax_prune_and_split,
)
from burn_raymarching_tpu_torch.config import DensityConfig
from burn_raymarching_tpu_torch.native import lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every rule moved off its default, each to a value of its own, so a field
# the wrapper hands the C++ struct in the wrong slot changes the outcome.
_CUSTOM_RULES = dict(
    prune_min_radius=0.02, prune_max_radius_base=1.5,
    prune_max_radius_decay=0.1, prune_flyaway_dist_sq=1.0,
    prune_black_color_sum=0.3, split_radius_base=0.4,
    split_radius_decay=0.5, split_move_dist=0.08,
    split_child_radius_scale=0.6, split_child_min_radius=0.05,
)
_RULES = {"default": {}, "custom": _CUSTOM_RULES}


@pytest.fixture
def native():
    """Skips where the library does not build (no g++), decided at run
    time."""
    if not lib.is_available():
        pytest.skip("native toolchain unavailable")
    return lib


def _scene(m=24, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 0.6, (m, 3)).astype(np.float32)
    colors = rng.normal(0, 3, (m, 3)).astype(np.float32)
    radii = rng.normal(-1, 1.5, (m, 1)).astype(np.float32)
    init = centers + rng.normal(0, 0.2, (m, 3)).astype(np.float32)
    return centers, colors, radii, init


def _rows(c, col, r):
    """[K, 7] rows sorted, so outputs in different row orders compare."""
    rows = np.concatenate([c, col, np.asarray(r).reshape(-1, 1)], axis=1)
    return rows[np.lexsort(rows.T)]


def test_source_is_the_repositorys_native_source():
    with open(os.path.join(ROOT, "native", "burn_native.cpp"), "rb") as f:
        original = f.read()
    with open(lib.SRC, "rb") as f:
        assert f.read() == original
    assert lib.BUILD_DIR.startswith(os.path.join(
        ROOT, "burn_raymarching_tpu_torch"))


@pytest.mark.parametrize("rules", sorted(_RULES))
@pytest.mark.parametrize("stage", [0, 2, 4])
def test_density_native_matches_jax_with_injected_dirs(native, stage, rules):
    """The JAX prune_and_split draws its split directions from its rng; the
    same directions, read back from its children (c ± d·r/2), go into the
    C++ path, whose rows must then equal the JAX rows."""
    centers, colors, radii, init = _scene()
    kw = _RULES[rules]
    jc, jcol, jr, jstats = jax_prune_and_split(
        centers, colors, radii, init, stage, 5, np.random.default_rng(1),
        JaxDensityConfig(**kw))
    h, s = jstats.kept, jstats.split
    plus, minus = jc[h:h + s], jc[h + s:h + 2 * s]
    assert jc.shape[0] == h + 2 * s
    # Each split parent is the midpoint of its two children.
    mid = 0.5 * (plus + minus)
    gap = ((mid[:, None, :] - centers[None]) ** 2).sum(-1)
    parent = gap.argmin(1)
    assert np.all(gap[np.arange(s), parent] < 1e-10)
    assert len(set(parent.tolist())) == s
    dirs = np.tile(np.float32([0.0, 0.0, 1.0]), (centers.shape[0], 1))
    step = plus - minus
    dirs[parent] = step / np.linalg.norm(step, axis=1, keepdims=True)

    nc, ncol, nr, stats = native.prune_and_split_native(
        centers, colors, radii, init, stage, 5, seed=1,
        cfg=DensityConfig(**kw), dirs=dirs)
    assert stats == {k: getattr(jstats, k) for k in stats}
    assert nr.shape == (nc.shape[0], 1) and ncol.shape == (nc.shape[0], 3)
    np.testing.assert_allclose(_rows(nc, ncol, nr), _rows(jc, jcol, jr),
                               rtol=1e-5, atol=1e-6)


def test_density_cases_exercise_splits_and_prunes():
    """The seeded scene drives every rule of the cases above: at stage 0 both
    rule sets split and prune, and the two sets disagree."""
    centers, colors, radii, init = _scene()
    got = {}
    for name, kw in _RULES.items():
        _, _, _, st = jax_prune_and_split(
            centers, colors, radii, init, 0, 5, np.random.default_rng(1),
            JaxDensityConfig(**kw))
        assert st.split > 0 and st.kept > 0
        assert st.pruned_size + st.pruned_flyaway + st.pruned_black > 0
        got[name] = dataclasses.astuple(st)
    assert got["default"] != got["custom"]
    assert set(_CUSTOM_RULES) <= {
        f.name for f in dataclasses.fields(DensityConfig)}


@pytest.mark.parametrize("stage", [0, 1, 4])
def test_density_native_stats_match_jax(native, stage):
    """The library's own RNG draws other directions, so only the counts
    (which no direction moves) are held to the JAX path's."""
    centers, colors, radii, init = _scene(seed=11)
    _, _, _, jstats = jax_prune_and_split(
        centers, colors, radii, init, stage, 5, np.random.default_rng(0))
    nc, _, _, stats = native.prune_and_split_native(
        centers, colors, radii, init, stage, 5, seed=0)
    assert stats == {k: getattr(jstats, k) for k in stats}
    assert nc.shape[0] == stats["kept"] + 2 * stats["split"]


def test_camera_rays_native_matches_jax(native):
    for pose in ([0.0, 0.5, -2.5], [2.5, 0.0, 0.1], [0.0, 2.5, -0.001]):
        ro_j, rd_j = jax_camera_rays(64, 48, pose, [0, 0, 0], 50.0)
        ro_c, rd_c = native.camera_rays_native(64, 48, pose, [0, 0, 0], 50.0)
        np.testing.assert_allclose(ro_c, np.asarray(ro_j), atol=1e-6)
        np.testing.assert_allclose(rd_c, np.asarray(rd_j), atol=1e-5)


def test_camera_rays_native_threaded_consistent(native):
    a = native.camera_rays_native(256, 256, [0, 0.5, -2.5], [0, 0, 0], 50.0,
                                  num_threads=1)
    b = native.camera_rays_native(256, 256, [0, 0.5, -2.5], [0, 0, 0], 50.0,
                                  num_threads=4)
    np.testing.assert_array_equal(a[1], b[1])


def test_failed_build_raises_when_called(monkeypatch, tmp_path):
    """A source that does not compile: is_available() reports False, and
    each function raises with the compiler's message."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(lib, "SRC", str(bad))
    monkeypatch.setattr(lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib, "_error", None)
    assert not lib.is_available()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        lib.camera_rays_native(4, 4, [0, 0, -1], [0, 0, 0], 50.0)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        lib.prune_and_split_native(*_scene(4), 0, 5)

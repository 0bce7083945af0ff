"""ops/culling: the port's tile cones, flat and hierarchical top-K selection,
cluster building and table gathers against the JAX package's, on the same
numpy inputs.

Cones, scores and bounds: rtol 1e-5 (float32 reductions in another order).
Selections compare as per-tile SETS of valid primitive ids: the slot order
of culled (+inf) entries is not compared, since they are invalid either
way. Cluster membership is NumPy on both sides: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.ops import culling as jc
from burn_raymarching_tpu.utils.morton import morton_permutation
from burn_raymarching_tpu_torch.ops import culling as tc

TILE = 64
K = 18.5         # smooth_k


@pytest.fixture(scope="module")
def scene():
    """A 16x16 view in Morton order (4 tiles of 64) and 60 primitives, 10
    of them masked out."""
    ro, rd = j_rays(16, 16, [0.2, 0.4, -1.8], [0.0, 0.0, 0.0], 50.0)
    perm = morton_permutation(16, 16)
    ro, rd = np.asarray(ro)[perm], np.asarray(rd)[perm]
    rng = np.random.default_rng(3)
    m = 60
    centers = rng.normal(0, 0.35, (m, 3)).astype(np.float32)
    radii = (0.03 + 0.1 * rng.random((m, 1))).astype(np.float32)
    colors = rng.random((m, 3)).astype(np.float32)
    mask = rng.random(m) > 0.15
    return ro, rd, centers, radii, colors, mask


def _cones(scene):
    ro, rd = scene[0], scene[1]
    return (jc.tile_cones(jnp.asarray(ro), jnp.asarray(rd), TILE),
            tc.tile_cones(tt(ro), tt(rd), TILE))


def test_tile_cones_match_jax(scene):
    cj, ct = _cones(scene)
    for name in cj._fields:
        np.testing.assert_allclose(nn(getattr(ct, name)),
                                   np.asarray(getattr(cj, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_cone_distance_matches_jax(scene):
    cj, ct = _cones(scene)
    c = scene[2]
    np.testing.assert_allclose(nn(tc.cone_point_distance(ct, tt(c))),
                               np.asarray(jc.cone_point_distance(
                                   cj, jnp.asarray(c))),
                               rtol=1e-5, atol=1e-6)


def _sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [set(idx[b][valid[b]].tolist()) for b in range(idx.shape[0])]


@pytest.mark.parametrize("budget", [8, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_flat_selection_matches_jax_as_sets(scene, budget, masked):
    _, _, c, r, _, mask = scene
    cj, ct = _cones(scene)
    jm = jnp.asarray(mask) if masked else None
    tm = tt(mask) if masked else None
    idx_j, val_j = jc.select_tile_primitives(cj, jnp.asarray(c),
                                             jnp.asarray(r), K, budget,
                                             mask=jm)
    idx_t, val_t = tc.select_tile_primitives(ct, tt(c), tt(r), K, budget,
                                             mask=tm)
    assert idx_t.shape == idx_j.shape
    got, want = _sets(nn(idx_t), nn(val_t)), _sets(idx_j, val_j)
    assert got == want
    assert any(len(s) for s in want)
    np.testing.assert_array_equal(
        nn(tc.selection_overflow(ct, tt(c), tt(r), K, budget, mask=tm)),
        np.asarray(jc.selection_overflow(cj, jnp.asarray(c), jnp.asarray(r),
                                         K, budget, mask=jm)))


def test_overflowing_selection_breaks_ties_like_jax(scene):
    """Primitives inside a tile's cone all score −radius; with one radius
    for all (the cloud init's) and more of them than the budget, the kept
    set is decided by the tie-break alone: the lower index, as in
    jax.lax.top_k."""
    cj, ct = _cones(scene)
    rng = np.random.default_rng(5)
    c = rng.normal(0, 0.05, (40, 3)).astype(np.float32)
    r = np.full((40, 1), 0.05, np.float32)
    idx_j, val_j = jc.select_tile_primitives(cj, jnp.asarray(c),
                                             jnp.asarray(r), K, 8)
    idx_t, val_t = tc.select_tile_primitives(ct, tt(c), tt(r), K, 8)
    want = _sets(idx_j, val_j)
    assert _sets(nn(idx_t), nn(val_t)) == want
    assert nn(tc.selection_overflow(ct, tt(c), tt(r), K, 8)).max() > 0
    assert max(len(s) for s in want) == 8


@pytest.mark.parametrize("masked", [False, True])
def test_build_clusters_matches_jax_exactly(scene, masked):
    c, mask = scene[2], (scene[5] if masked else None)
    cl_j = jc.build_clusters(c, mask=mask, group=8)
    cl_t = tc.build_clusters(c, mask=mask, group=8, device="cpu")
    np.testing.assert_array_equal(nn(cl_t.member_idx),
                                  np.asarray(cl_j.member_idx))
    np.testing.assert_array_equal(nn(cl_t.member_valid),
                                  np.asarray(cl_j.member_valid))


def test_morton_order_matches_jax(scene):
    np.testing.assert_array_equal(tc.morton_order(scene[2]),
                                  jc.morton_order(scene[2]))


def test_cluster_bounds_match_jax(scene):
    _, _, c, r, _, mask = scene
    cl_j = jc.build_clusters(c, mask=mask, group=8)
    cl_t = tc.build_clusters(c, mask=mask, group=8, device="cpu")
    want = jc.cluster_bounds(cl_j, jnp.asarray(c), jnp.asarray(r),
                             mask=jnp.asarray(mask))
    got = tc.cluster_bounds(cl_t, tt(c), tt(r), mask=tt(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nn(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("cluster_budget", [2, 8])
def test_hier_selection_matches_jax_as_sets(scene, cluster_budget):
    _, _, c, r, _, mask = scene
    cj, ct = _cones(scene)
    cl_j = jc.build_clusters(c, mask=mask, group=8)
    cl_t = tc.build_clusters(c, mask=mask, group=8, device="cpu")
    idx_j, val_j = jc.select_tile_primitives_hier(
        cj, jnp.asarray(c), jnp.asarray(r), K, 16, cl_j, cluster_budget,
        mask=jnp.asarray(mask))
    idx_t, val_t = tc.select_tile_primitives_hier(
        ct, tt(c), tt(r), K, 16, cl_t, cluster_budget, mask=tt(mask))
    assert _sets(nn(idx_t), nn(val_t)) == _sets(idx_j, val_j)
    np.testing.assert_array_equal(
        nn(tc.cluster_overflow(ct, tt(c), tt(r), K, cl_t, cluster_budget,
                               mask=tt(mask))),
        np.asarray(jc.cluster_overflow(cj, jnp.asarray(c), jnp.asarray(r), K,
                                       cl_j, cluster_budget,
                                       mask=jnp.asarray(mask))))


def test_gather_tile_tables_match_jax(scene):
    _, _, c, r, col, mask = scene
    cj, _ = _cones(scene)
    idx, valid = jc.select_tile_primitives(cj, jnp.asarray(c),
                                           jnp.asarray(r), K, 16,
                                           mask=jnp.asarray(mask))
    want = jc.gather_tile_tables(jnp.asarray(c), jnp.asarray(col),
                                 jnp.asarray(r), idx, valid)
    got = tc.gather_tile_tables(tt(c), tt(col), tt(r),
                                tt(idx).long(), tt(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nn(g), np.asarray(w), rtol=1e-6)

"""The slices as a whole: training steps of the port against a JAX step
assembled from the JAX package's pieces (dense), or the JAX package's own
step body with the batch indices injected (culled, config 4), and tiny CPU
runs of the port's CLI (stages, previews, scene.json, checkpoints, resume;
the config-4 flags)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    DANGO_CENTERS,
    DANGO_COLORS,
    DANGO_RADII,
    jax_params,
    nn,
)

from burn_raymarching_tpu.config import TrainConfig
from burn_raymarching_tpu.data.camera import create_camera_rays as j_rays
from burn_raymarching_tpu.data.dataset import gather_batch as j_gather
from burn_raymarching_tpu.models.scene import init_scene_params as j_init
from burn_raymarching_tpu.models.scene import pad_params as j_pad
from burn_raymarching_tpu.models.scene import scene_forward as j_forward
from burn_raymarching_tpu.render.gt import render_gt as j_gt
from burn_raymarching_tpu.train.loss import compute_loss as j_loss
from burn_raymarching_tpu.train.optimizer import make_optimizer as j_opt
from burn_raymarching_tpu.train.step_body import lr_scale_tree as j_scales
from burn_raymarching_tpu.train.step_body import schedule_for_step as j_sched
from burn_raymarching_tpu_torch.models.scene import (
    PARAM_KEYS,
    pad_params,
    params_from_numpy,
)
from burn_raymarching_tpu_torch.tools import generate, train_cli
from burn_raymarching_tpu_torch.train.optimizer import (
    make_optimizer,
    set_group_lrs,
)
from burn_raymarching_tpu_torch.train.step_body import (
    lr_scale_tree,
    make_device_step,
    schedule_for_step,
)


@pytest.mark.parametrize("stage,step", [(0, 1), (0, 350), (0, 351),
                                        (2, 700), (4, 700), (4, 1000)])
def test_schedule_matches_jax_float32(stage, step):
    cfg = TrainConfig()
    want = [float(x) for x in j_sched(cfg, jnp.int32(stage),
                                      jnp.int32(step))]
    got = schedule_for_step(cfg, stage, step)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def small_dataset():
    """Two 16x16 views of the dango scene → packed [P, 9] (numpy)."""
    rows = []
    for eye in ([0.0, 0.3, -1.5], [1.5, 0.3, 0.0]):
        ro, rd = j_rays(16, 16, eye, [0.0, 0.0, 0.0], 50.0)
        tgt = j_gt(ro, rd, jnp.asarray(DANGO_CENTERS),
                   jnp.asarray(DANGO_COLORS), jnp.asarray(DANGO_RADII))
        rows.append(np.concatenate([np.asarray(ro), np.asarray(rd),
                                    np.asarray(tgt)], axis=1))
    return np.concatenate(rows).astype(np.float32)


def test_five_training_steps_match_jax(small_dataset):
    cfg = TrainConfig(batch_size=256, stages=2, steps_per_stage=10,
                      use_pallas=False)
    packed = small_dataset
    rng = np.random.default_rng(0)
    idxs = [rng.integers(0, packed.shape[0], 256) for _ in range(5)]
    stage = 0

    # JAX: gather → scene_forward (march_xla) → compute_loss → optax.
    pj, mask_j = j_pad(j_init(7), 8)
    tx = j_opt(cfg)
    st = tx.init(pj)
    scales_j = j_scales(cfg)

    # Port: the trainer's step body with injected indices.
    pt, mask_t = pad_params(params_from_numpy(
        {k: np.asarray(getattr(j_init(7), k)) for k in PARAM_KEYS}), 8)
    opt = make_optimizer(cfg, pt)
    step_fn = make_device_step(cfg, march_normal_fn=None, batch=256)
    packed_t = torch.as_tensor(packed)
    fg = torch.zeros(packed.shape[0], dtype=torch.int32)

    for step, idx in enumerate(idxs, start=1):
        progress, k, _, lr = j_sched(cfg, jnp.int32(stage), jnp.int32(step))
        ro, rd, tgt = j_gather(jnp.asarray(packed), jnp.asarray(idx))

        def loss_fn(p):
            out = j_forward(p, ro, rd, k, mask=mask_j)
            return j_loss(p, out, tgt, progress, mask=mask_j, cfg=cfg.loss)

        loss_j, g = jax.value_and_grad(loss_fn)(pj)
        upd, st = tx.update(g, st, pj)
        pj = jax.tree.map(lambda p, u, s: p - lr * s * u, pj, upd, scales_j)

        loss_t, lr_t = step_fn(pt, None, stage, step, mask_t, packed_t, fg,
                               0, idx=torch.as_tensor(idx))
        set_group_lrs(opt, lr_t, lr_scale_tree(cfg))
        opt.step()

        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
        for name in PARAM_KEYS:
            np.testing.assert_allclose(nn(getattr(pt, name)),
                                       np.asarray(getattr(pj, name)),
                                       atol=1e-4, err_msg=f"{name} @ {step}")


def test_five_warm_dense_steps_match_jax(small_dataset, monkeypatch):
    """--turbo on the dense path: five steps that march 16 steps from
    0.8 x the cached t through K1's wrapper (its plain version on the CPU)
    and write the cache back, against the JAX package's own step with K1 in
    interpret mode and the same indices injected into its sampler. The
    plain tail shades (use_fused_shade off: K2 is tested on its own).
    Loss rtol 1e-4 and parameters atol 1e-4 (1e-6 and 2e-6 seen). The t
    cache: 95% of the rays that hit (t < 10) within 1e-4, and
    |dt|/(1+t) <= 5e-4 on all. Each step starts its rays from the cache
    the earlier steps wrote, so the two marches' float32 differences
    compound: 1.8e-7 after step 1, 1.2e-3 on 3.6% of the hit rays by
    step 5."""
    import functools

    import burn_raymarching_tpu.train.step_body as jsb
    from burn_raymarching_tpu.ops.march import march_xla
    from burn_raymarching_tpu.ops.pallas.march_shade_kernel import (
        march_shade_pallas,
    )
    from burn_raymarching_tpu_torch.ops.cuda.march_shade_kernel import (
        march_shade,
    )

    cfg = TrainConfig(batch_size=256, stages=2, steps_per_stage=10,
                      warm_start=True, use_fused_shade=False)
    packed = small_dataset
    rng = np.random.default_rng(2)
    idxs = [rng.integers(0, packed.shape[0], 256).astype(np.int32)
            for _ in range(5)]
    t_cache0 = rng.uniform(1.0, 2.5, packed.shape[0]).astype(np.float32)
    stage = 0

    calls = iter(idxs)
    monkeypatch.setattr(jsb, "sample_batch_indices",
                        lambda *a, **kw: jnp.asarray(next(calls)))
    step_j = jsb.make_device_step(
        cfg, march_fn=march_xla,
        march_normal_fn=functools.partial(march_shade_pallas, interpret=True,
                                          tile_n=64),
        culled_march_fn=None, repulsion_fn=None, batch=256, warm=True)
    pj, mask_j = j_pad(j_init(7), 8)
    tx = j_opt(cfg)
    st = tx.init(pj)
    scales_j = j_scales(cfg)
    cache_j = jnp.asarray(t_cache0)
    empty = jnp.zeros((0, 0), jnp.int32)

    pt, mask_t = pad_params(params_from_numpy(
        {k: np.asarray(getattr(j_init(7), k)) for k in PARAM_KEYS}), 8)
    opt = make_optimizer(cfg, pt)
    step_t = make_device_step(cfg, march_normal_fn=march_shade, batch=256,
                              warm=True)
    cache_t = torch.as_tensor(t_cache0.copy())
    packed_t = torch.as_tensor(packed)
    fg = torch.zeros(packed.shape[0], dtype=torch.int32)

    for step, idx in enumerate(idxs, start=1):
        loss_j, g, cache_j, lr = step_j(
            pj, jax.random.PRNGKey(0), jnp.int32(step - 1), jnp.int32(stage),
            jnp.int32(0), mask_j, jnp.asarray(packed), jnp.asarray(nn(fg)),
            jnp.int32(0), cache_j, empty, empty.astype(bool))
        upd, st = tx.update(g, st, pj)
        pj = jax.tree.map(lambda p, u, s: p - lr * s * u, pj, upd, scales_j)

        loss_t, lr_t = step_t(pt, None, stage, step, mask_t, packed_t, fg, 0,
                              idx=torch.as_tensor(idx).long(),
                              t_cache=cache_t)
        set_group_lrs(opt, lr_t, lr_scale_tree(cfg))
        opt.step()

        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
        c_t, c_j = nn(cache_t), np.asarray(cache_j)
        dt = np.abs(c_t - c_j)
        assert np.mean(dt[c_j < 10.0] <= 1e-4) >= 0.95, step
        assert (dt / (1.0 + c_j)).max() <= 5e-4, step
        for name in PARAM_KEYS:
            np.testing.assert_allclose(nn(getattr(pt, name)),
                                       np.asarray(getattr(pj, name)),
                                       atol=1e-4, err_msg=f"{name} @ {step}")
    assert not np.array_equal(nn(cache_t), t_cache0)


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    out = str(root / "data")
    generate.main(["--out", out, "--size", "32", "--device", "cpu"])
    return os.path.join(out, "cameras.json")


def _cli(tiny_data, run_dir, *extra):
    return train_cli.main([
        "--cameras", tiny_data, "--width", "32", "--height", "32",
        "--stages", "2", "--steps", "4", "--batch", "256",
        "--scene-out", os.path.join(run_dir, "scene.json"),
        "--steps-dir", os.path.join(run_dir, "steps"),
        "--checkpoint-dir", os.path.join(run_dir, "ckpt"),
        "--device", "cpu", *extra])


def test_cli_run_writes_outputs_and_resumes(tiny_data, tmp_path, capsys):
    run = str(tmp_path)
    trainer, padded, mask = _cli(tiny_data, run)
    assert len(trainer.loss_history) == 2
    assert all(np.isfinite(trainer.loss_history))
    for f in ("scene.json", "steps/stage_0.png", "steps/final_1.png",
              "ckpt/stage_1.npz"):
        assert os.path.exists(os.path.join(run, f)), f
    with open(os.path.join(run, "scene.json")) as fh:
        scene = json.load(fh)
    assert scene["num_spheres"] == int(mask.sum())
    with np.load(os.path.join(run, "ckpt/stage_1.npz")) as ck:
        assert set(ck.files) == {"stage", "key", *PARAM_KEYS}
    capsys.readouterr()
    trainer2, _, _ = _cli(tiny_data, run, "--resume")
    assert "Resuming from stage 1 checkpoint" in capsys.readouterr().out
    assert len(trainer2.loss_history) == 1


def test_resumes_from_a_jax_checkpoint(tiny_data, tmp_path, capsys):
    """A JAX stage_k.npz (raw params + a jax PRNG key) resumes in the port."""
    p = j_init(9)
    os.makedirs(tmp_path / "ckpt")
    np.savez(tmp_path / "ckpt" / "stage_1.npz", stage=1,
             key=np.asarray(jax.random.PRNGKey(3)),
             **{k: np.asarray(getattr(p, k)) for k in PARAM_KEYS})
    _, _, mask = _cli(tiny_data, str(tmp_path), "--resume")
    out = capsys.readouterr().out
    assert "Resuming from stage 1" in out and "(N = 9)" in out
    assert int(mask.sum()) == 9


def test_cuda_request_without_card_raises(tiny_data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--cameras", tiny_data, "--device", "cuda"])


# --- config 4: culled, tile-sampled, warm-started, cluster repulsion ----- #

C4_FLAGS = ["--init-layout", "cloud", "--init-n", "120", "--turbo",
            "--cull", "32", "--sample-mode", "tile", "--cluster-repulsion",
            "--wd-mode", "decoupled", "--lr", "0.02",
            "--lr-scales", "0.001,1,0.1,0.5", "--smooth-k", "128",
            "--sharp", "40,60", "--merge-cell", "0.04"]


@pytest.fixture(scope="module")
def tiny_knot(tmp_path_factory):
    """2 views of the knot at 32x32 from the port's generator."""
    out = str(tmp_path_factory.mktemp("knot") / "data")
    generate.main(["--out", out, "--size", "32", "--views", "2", "--scene",
                   "knot", "--gt-k", "128", "--gt-sharp", "40",
                   "--device", "cpu"])
    return out


def test_five_culled_training_steps_match_jax(tiny_knot, monkeypatch):
    """Five config-4 steps (tile batches, culled warm-started march, cluster
    repulsion with frozen tables, decoupled decay) against the JAX package's
    own make_device_step with the same tile ids injected into its sampler.

    The port's step marches through JAX's culled_march_normals_xla, passed
    in as its culled_march_fn, so both steps see one march and this test
    holds the step's wiring (sort, selection, warm start and cache write,
    re-gathered tail, loss, optimizer) to float32 agreement: loss rtol
    1e-4, parameters atol 1e-4, the t cache atol 1e-4 on rays that hit
    (t < 10) and |dt|/(1+t) <= 1e-4 on the rays that miss, which pass
    close to spheres on their way out to t ~ 1e4 and carry the parameters'
    1e-7 differences into t (3.6e-5 relative seen at t = 162). The march
    itself is held to JAX's in tests/test_torch_culled.py. With two
    marches the steps part by float32 noise: at k = 128 around the init's
    0.03 spheres the port's and JAX's normals each differ from a float64
    march by ~3e-3, which moves the light gradient by 4% and one Adam step
    of light_dir by 3e-4.
    """
    import burn_raymarching_tpu.train.step_body as jsb
    from burn_raymarching_tpu.ops.culling import PrimitiveClusters
    from burn_raymarching_tpu.ops.march import march_xla
    from burn_raymarching_tpu.render.culled import culled_march_normals_xla
    from burn_raymarching_tpu.train.loss import build_repulsion_static as jst
    from burn_raymarching_tpu_torch.ops.culling import build_clusters
    from burn_raymarching_tpu_torch.train.loop import build_dataset
    from burn_raymarching_tpu_torch.train.loss import build_repulsion_static

    cfg = train_cli.build_config(train_cli.make_parser().parse_args(
        ["--cameras", os.path.join(tiny_knot, "cameras.json"),
         "--width", "32", "--height", "32", "--batch", "512",
         "--init-points", os.path.join(tiny_knot, "points.json"),
         "--no-pallas", *C4_FLAGS]))
    # A budget that holds every primitive, as config 4's 2,048 holds its
    # tiles' qualifying sets: an overflowing tile's cut falls between
    # scores that float32 rounding orders differently in the two packages.
    cfg = dataclasses.replace(cfg, cull_tile=128, cull_cluster_group=8,
                              cull_budget=128)
    ds = build_dataset(cfg)
    packed = nn(ds.packed)
    n_tiles = packed.shape[0] // cfg.cull_tile
    rng = np.random.default_rng(4)
    tids = [rng.integers(0, n_tiles, 4).astype(np.int32) for _ in range(5)]
    t_cache0 = rng.uniform(1.0, 2.5, packed.shape[0]).astype(np.float32)
    stage = 1

    from burn_raymarching_tpu_torch.train.loop import Trainer

    pt, mask_t = pad_params(Trainer(cfg, ds, log=lambda s: None)
                            ._init_params(), 128)
    raw = {k: nn(getattr(pt, k)) for k in PARAM_KEYS}
    mask = nn(mask_t)
    cl_t = build_clusters(raw["centers"], mask=mask, group=8)

    # JAX: its step body, sampler patched to return the injected tile ids.
    calls = iter(tids)
    monkeypatch.setattr(jsb, "sample_batch_indices",
                        lambda *a, **kw: jnp.asarray(next(calls)))
    step_j = jsb.make_device_step(
        cfg, march_fn=march_xla, march_normal_fn=None, culled_march_fn=None,
        repulsion_fn=None, batch=cfg.batch_size, warm=True)
    pj = jax_params(raw)
    tx = j_opt(cfg)
    st = tx.init(pj)
    scales_j = j_scales(cfg)
    cl_j = PrimitiveClusters(jnp.asarray(nn(cl_t.member_idx), jnp.int32),
                             jnp.asarray(nn(cl_t.member_valid)))
    mask_j = jnp.asarray(mask)
    static_j = jst(pj.centers, cl_j, mask_j)
    cache_j = jnp.asarray(t_cache0)

    # Port: the trainer's step body with the same indices.
    def jax_march(*args, t_init=None, **kw):
        t, n = culled_march_normals_xla(
            *(jnp.asarray(nn(a)) if torch.is_tensor(a) else a for a in args),
            t_init=None if t_init is None else jnp.asarray(nn(t_init)), **kw)
        return torch.tensor(np.asarray(t)), torch.tensor(np.asarray(n))

    step_t = make_device_step(cfg, march_normal_fn=None,
                              batch=cfg.batch_size, culled_march_fn=jax_march,
                              warm=True)
    opt = make_optimizer(cfg, pt)
    static_t = build_repulsion_static(pt.centers, cl_t, mask_t)
    cache_t = torch.as_tensor(t_cache0.copy())
    fg = torch.zeros(n_tiles, dtype=torch.int32)

    for step, tid in enumerate(tids, start=1):
        loss_j, g, cache_j, lr = step_j(
            pj, jax.random.PRNGKey(0), jnp.int32(step - 1),
            jnp.int32(stage), jnp.int32(0), mask_j, jnp.asarray(packed),
            jnp.zeros(n_tiles, jnp.int32), jnp.int32(0), cache_j,
            cl_j.member_idx, cl_j.member_valid, rep_static=static_j)
        upd, st = tx.update(g, st, pj)
        pj = jax.tree.map(lambda p, u, s: p - lr * s * u, pj, upd, scales_j)

        idx = (torch.as_tensor(tid).long()[:, None] * cfg.cull_tile
               + torch.arange(cfg.cull_tile)).reshape(-1)
        loss_t, lr_t = step_t(pt, None, stage, step, mask_t,
                              torch.as_tensor(packed), fg, 0, idx=idx,
                              t_cache=cache_t, clusters=cl_t,
                              rep_static=static_t)
        set_group_lrs(opt, lr_t, lr_scale_tree(cfg))
        opt.step()

        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
        c_t, c_j = nn(cache_t), np.asarray(cache_j)
        hit = c_j < 10.0
        np.testing.assert_allclose(c_t[hit], c_j[hit], atol=1e-4,
                                   err_msg=f"t cache @ {step}")
        assert (np.abs(c_t - c_j) / (1.0 + c_j)).max() <= 1e-4, step
        for name in PARAM_KEYS:
            np.testing.assert_allclose(nn(getattr(pt, name)),
                                       np.asarray(getattr(pj, name)),
                                       atol=1e-4, err_msg=f"{name} @ {step}")
    assert not np.array_equal(nn(cache_t), t_cache0)


def test_cli_runs_config4_flags_on_tiny_knot(tiny_knot, tmp_path):
    """train_cli with the config-4 flags (budget and init cut to size): two
    stages cross a boundary with the merge, the t cache and the cluster
    table are live, and the culled preview and scene.json are written."""
    run = str(tmp_path)
    trainer, padded, mask = train_cli.main([
        "--cameras", os.path.join(tiny_knot, "cameras.json"),
        "--width", "32", "--height", "32", "--stages", "2", "--steps", "3",
        "--batch", "1024",
        "--init-points", os.path.join(tiny_knot, "points.json"),
        "--scene-out", os.path.join(run, "scene.json"),
        "--steps-dir", os.path.join(run, "steps"),
        "--checkpoint-dir", "", "--device", "cpu", *C4_FLAGS])
    cfg = trainer.cfg
    assert cfg.use_culling and cfg.warm_start and cfg.cluster_repulsion
    assert cfg.dataset_order == "morton" and cfg.sample_mode == "tile"
    assert trainer.warm and trainer._cull_render() is not None
    assert len(trainer.loss_history) == 2
    assert all(np.isfinite(trainer.loss_history))
    assert float(trainer.t_cache.abs().max()) > 0.0
    assert trainer._sample_fg[1] > 0
    for f in ("scene.json", "steps/stage_0.png", "steps/final_1.png"):
        assert os.path.exists(os.path.join(run, f)), f
    with open(os.path.join(run, "scene.json")) as fh:
        assert json.load(fh)["num_spheres"] == int(mask.sum())


def _c4_cfg(tiny_knot, *extra):
    return train_cli.build_config(train_cli.make_parser().parse_args(
        ["--cameras", os.path.join(tiny_knot, "cameras.json"),
         "--width", "32", "--height", "32", "--batch", "512",
         "--init-points", os.path.join(tiny_knot, "points.json"),
         *C4_FLAGS, *extra]))


def test_morton_dataset_and_tile_pools_match_jax(tiny_knot):
    """build_dataset's Morton order and RayDataset.tile_fg are the JAX
    package's, exactly; a tile-mode batch is whole cull_tile blocks of the
    pool."""
    from burn_raymarching_tpu.train.loop import build_dataset as j_build
    from burn_raymarching_tpu_torch.train.loop import build_dataset
    from burn_raymarching_tpu_torch.train.step_body import sample_step_indices

    cfg = dataclasses.replace(_c4_cfg(tiny_knot), cull_tile=128)
    assert cfg.dataset_order == "morton"
    ds, ds_j = build_dataset(cfg), j_build(cfg)
    np.testing.assert_allclose(nn(ds.packed), np.asarray(ds_j.packed),
                               rtol=1e-6, atol=1e-7)
    fg, n_fg = ds.tile_fg(128)
    fg_j, n_fg_j = ds_j.tile_fg(128)
    assert n_fg == n_fg_j and 0 < n_fg < ds.num_total_pixels // 128
    np.testing.assert_array_equal(nn(fg), np.asarray(fg_j))

    gen = torch.Generator().manual_seed(0)
    idx = sample_step_indices(cfg, gen, ds.num_total_pixels, fg, n_fg, 512,
                              0.5)
    blocks = nn(idx).reshape(4, 128)
    np.testing.assert_array_equal(blocks - blocks[:, :1], np.arange(128)
                                  * np.ones((4, 1), np.int64))
    assert (blocks[:, 0] % 128 == 0).all()
    assert blocks.max() < ds.num_total_pixels


def test_ceiling_and_init_psnr_match_jax(tiny_knot):
    """The two deterministic rows of the config-4 record through the
    port's evaluator against the JAX package's on the tiny knot set: the
    GT scene through the dense forward (ceiling) and the prior-seeded init
    through the culled forward in Morton order (init). PSNR within 0.05 dB
    (the 8-bit PSNR of a few grazing pixels moves with float32 rounding)."""
    from burn_raymarching_tpu.data.image_io import load_image_as_array
    from burn_raymarching_tpu.data.scene_io import load_cameras as j_cams
    from burn_raymarching_tpu.models.scene import (
        init_scene_params_cloud as j_cloud,
    )
    from burn_raymarching_tpu.render.preview import CullRender as JCull
    from burn_raymarching_tpu.train.evaluate import evaluate_views as j_eval
    from burn_raymarching_tpu.utils.padding import bucket_size
    from burn_raymarching_tpu_torch.tools import run_c5
    from burn_raymarching_tpu_torch.train.loop import Trainer, build_dataset

    cfg = dataclasses.replace(_c4_cfg(tiny_knot), cull_budget=64,
                              cull_tile=128)
    tr = Trainer(cfg, build_dataset(cfg), log=lambda s: None)
    cams = j_cams(cfg.cameras_json)
    tgts = [load_image_as_array(c["file"]) for c in cams]
    kw = dict(smooth_k=128.0, softmax_sharpness=40.0, mask_sharpness=60.0)

    ceiling, gt_mask = run_c5.ceiling_padded(400, "cpu")
    got = tr.views_psnr(ceiling, gt_mask, dense=True)
    want = j_eval(jax_params({k: nn(getattr(ceiling, k))
                              for k in PARAM_KEYS}),
                  cams, tgts, 32, 32, mask=jnp.asarray(nn(gt_mask)),
                  **kw)["mean"]
    assert abs(got - want) < 0.05 and want > 25.0

    init, mask = run_c5.init_padded(tr)
    got = tr.views_psnr(init, mask)
    with open(cfg.init_points) as f:
        pts = np.asarray(json.load(f)["points"], np.float32).reshape(-1, 3)
    j_init_p = j_cloud(cfg.init_n, seed=cfg.seed, points=pts,
                       jitter=cfg.init_points_jitter)
    j_pad_p, j_mask = j_pad(j_init_p, bucket_size(cfg.init_n))
    np.testing.assert_allclose(nn(init.centers), np.asarray(j_pad_p.centers),
                               rtol=1e-6)
    want = j_eval(j_pad_p, cams, tgts, 32, 32, mask=j_mask,
                  cull=JCull(tile=128, k_budget=64), **kw)["mean"]
    assert abs(got - want) < 0.05

"""The port's own ``config`` and ``utils`` against the JAX package's.

The port imports nothing of the JAX package, so it keeps copies of the four
configuration dataclasses and of the NumPy / standard-library helpers
(padding buckets, Morton orders, metrics logger). Nothing is shared any
more; these tests are what notices a copy drifting from the reference.
Everything here is exact (integers, strings, field defaults), so there are
no tolerances.
"""

import dataclasses
import json

import numpy as np
import pytest

from burn_raymarching_tpu import config as j_config
from burn_raymarching_tpu.utils import metrics as j_metrics
from burn_raymarching_tpu.utils import morton as j_morton
from burn_raymarching_tpu.utils import padding as j_padding
from burn_raymarching_tpu_torch import config as t_config
from burn_raymarching_tpu_torch import utils as t_utils
from burn_raymarching_tpu_torch.utils import metrics as t_metrics
from burn_raymarching_tpu_torch.utils import morton as t_morton
from burn_raymarching_tpu_torch.utils import padding as t_padding

CONFIGS = ("RenderConfig", "LossConfig", "DensityConfig", "TrainConfig")


def _plain(value):
    """Nested config dataclasses → dicts, so the two packages' compare."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    return value


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_match(name):
    j_cls, t_cls = getattr(j_config, name), getattr(t_config, name)
    assert t_cls is not j_cls and t_cls.__module__.endswith("_torch.config")
    j_fields, t_fields = dataclasses.fields(j_cls), dataclasses.fields(t_cls)
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    assert [f.type for f in t_fields] == [f.type for f in j_fields]
    assert _plain(t_cls()) == _plain(j_cls())


@pytest.mark.parametrize("name", CONFIGS)
def test_config_is_frozen_and_replaceable_like_the_reference(name):
    j_cls, t_cls = getattr(j_config, name), getattr(t_config, name)
    field = dataclasses.fields(t_cls)[0]
    for cls in (j_cls, t_cls):
        cfg = cls()
        with pytest.raises(dataclasses.FrozenInstanceError):
            setattr(cfg, field.name, getattr(cfg, field.name))
    changed = {field.name: type(getattr(t_cls(), field.name))(3)}
    assert (_plain(dataclasses.replace(t_cls(), **changed))
            == _plain(dataclasses.replace(j_cls(), **changed)))
    # Public names of the class (methods, properties) are the same set.
    public = lambda cls: sorted(n for n in dir(cls) if not n.startswith("_"))
    assert public(t_cls) == public(j_cls)


@pytest.mark.parametrize("stages,steps", [(5, 700), (1, 1), (3, 1000),
                                          (2, 100), (0, 50)])
def test_train_config_total_steps(stages, steps):
    kw = dict(stages=stages, steps_per_stage=steps)
    assert (t_config.TrainConfig(**kw).total_steps
            == j_config.TrainConfig(**kw).total_steps == stages * steps)


def test_train_config_nested_overrides_match():
    """The config-4 recipe's overrides land in the same fields."""
    def build(mod):
        return mod.TrainConfig(
            batch_size=16384, use_culling=True, cull_budget=2048,
            warm_start=True, cluster_repulsion=True, sample_mode="tile",
            dataset_order="morton", init_layout="cloud",
            render=mod.RenderConfig(softmax_sharpness=40.0,
                                    mask_sharpness=60.0),
            loss=dataclasses.replace(mod.LossConfig()),
            density=mod.DensityConfig(merge_cell=0.04))
    assert _plain(build(t_config)) == _plain(build(j_config))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 128, 129, 1350, 5120,
                               51200])
@pytest.mark.parametrize("minimum", [8, 1, 128])
def test_bucket_size_matches(n, minimum):
    assert (t_padding.bucket_size(n, minimum)
            == j_padding.bucket_size(n, minimum))
    assert t_utils.bucket_size is t_padding.bucket_size


@pytest.mark.parametrize("width,height", [(1, 1), (4, 4), (16, 16), (8, 4),
                                          (5, 7), (64, 64), (33, 2)])
def test_morton_permutation_matches(width, height):
    got = t_morton.morton_permutation(width, height)
    want = j_morton.morton_permutation(width, height)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    xs, ys = np.arange(width * height) % 7, np.arange(width * height) % 5
    np.testing.assert_array_equal(t_morton.morton2(xs, ys),
                                  j_morton.morton2(xs, ys))


@pytest.mark.parametrize("width,height,views", [(4, 4, 1), (8, 8, 3),
                                                (6, 10, 2), (16, 16, 30)])
def test_multi_view_morton_permutation_matches(width, height, views):
    np.testing.assert_array_equal(
        t_utils.multi_view_morton_permutation(width, height, views),
        j_morton.multi_view_morton_permutation(width, height, views))


def _log_calls(logger):
    logger.log(stage=0, step=100, loss=0.125, smooth_k=8.9, wall_s=1.0)
    logger.log(stage=1, step=200, loss=0.0625, rays_per_s=8.8e6, wall_s=2.5)
    logger.log(event="done", n=7, wall_s=3.0)
    return logger.read()


def test_metrics_logger_writes_the_same_lines(tmp_path):
    """Same calls, same file: line for line (wall_s is passed in, so the
    clock does not enter), the parent directory is made, a rerun truncates,
    and no path means no file."""
    paths = {"jax": tmp_path / "a" / "metrics.jsonl",
             "torch": tmp_path / "b" / "metrics.jsonl"}
    rows = {"jax": _log_calls(j_metrics.MetricsLogger(str(paths["jax"]))),
            "torch": _log_calls(t_metrics.MetricsLogger(str(paths["torch"])))}
    assert paths["torch"].read_text() == paths["jax"].read_text()
    assert rows["torch"] == rows["jax"] and len(rows["torch"]) == 3
    assert json.loads(paths["torch"].read_text().splitlines()[0])["step"] == 100

    t_metrics.MetricsLogger(str(paths["torch"]))        # truncates
    assert paths["torch"].read_text() == ""
    silent = t_utils.MetricsLogger(None)
    silent.log(step=1)
    assert silent.read() == [] == j_metrics.MetricsLogger(None).read()
    stamped = t_metrics.MetricsLogger(str(paths["torch"]))
    stamped.log(step=1)
    assert set(stamped.read()[0]) == {"step", "wall_s"}

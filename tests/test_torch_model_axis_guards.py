"""Under an M-sharded table a kernel that marches a whole table is never
replaced by the plain march without a word: the culled march routes K3
through the union table or raises, and the renderers and the step refuse
a whole-table kernel under ``model_axis`` instead of ignoring it. (The JAX
package falls back to the plain march in the first case; the port does
not.) Nothing here reaches a collective, so the axis needs no process
group."""

from __future__ import annotations

import pytest
import torch

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.parallel.collectives import Axis
from burn_raymarching_tpu_torch.render.culled import (
    culled_march_normals_xla,
    render_diff_culled,
)
from burn_raymarching_tpu_torch.render.diff import render_diff
from burn_raymarching_tpu_torch.train.step_body import (
    culled_march_backend,
    make_device_step,
    sharded_culled_kernel_march,
)

AXIS = Axis(group=None, size=2, index=0)


def kern(*args, **kwargs):
    raise AssertionError("the kernel is only routed here, never called")


def test_culled_march_backend_routes():
    assert culled_march_backend(kern, 3) is kern
    union = culled_march_backend(kern, 4, AXIS)
    assert union.func is sharded_culled_kernel_march
    assert union.args == (kern, AXIS)
    plain = culled_march_backend(None, 3, AXIS)
    assert plain.func is culled_march_normals_xla
    assert plain.keywords == {"model_axis": AXIS}


@pytest.mark.parametrize("tiles", [1, 3, 5])
def test_culled_march_backend_refuses_tiles_that_do_not_split(tiles):
    with pytest.raises(ValueError, match="do not split"):
        culled_march_backend(kern, tiles, AXIS)


def _scene(n_rays: int = 32, m: int = 4):
    g = torch.Generator().manual_seed(0)
    ro = torch.zeros((n_rays, 3))
    ro[:, 2] = -2.5
    rd = torch.nn.functional.normalize(
        torch.randn((n_rays, 3), generator=g) * 0.1
        + torch.tensor([0.0, 0.0, 1.0]), dim=1)
    c = torch.randn((m, 3), generator=g) * 0.3
    col = torch.rand((m, 3), generator=g)
    r = torch.full((m, 1), 0.3)
    return (ro, rd, c, col, r, torch.tensor([0.1, 1.0, -0.2]),
            torch.tensor([0.2]), 32.0)


def test_render_diff_culled_refuses_a_whole_table_kernel():
    with pytest.raises(ValueError, match="precomputed"):
        render_diff_culled(*_scene(), tile=16, k_budget=4,
                           march_normal_fn=kern, model_axis=AXIS)


def test_render_diff_refuses_a_whole_table_kernel():
    with pytest.raises(ValueError, match="one model shard"):
        render_diff(*_scene(), march_normal_fn=kern, model_axis=AXIS)


def test_model_sharded_dense_step_refuses_k1():
    with pytest.raises(ValueError, match="K1"):
        make_device_step(TrainConfig(batch_size=64), march_normal_fn=kern,
                         batch=64, model_axis=AXIS)
    # The culled step takes K1 along (for nothing) and K3 through the union.
    make_device_step(TrainConfig(batch_size=64, use_culling=True,
                                 cull_tile=16),
                     march_normal_fn=kern, culled_march_fn=kern, batch=64,
                     model_axis=AXIS)

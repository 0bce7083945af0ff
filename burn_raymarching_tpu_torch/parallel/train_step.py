"""The sharded training step: rays data-parallel × primitives model-parallel
(port of burn_raymarching_tpu/parallel/train_step.py).

Row layout (JAX ``param_specs`` / ``opt_state_specs``): the ``ROW_LEAVES``
``centers``, ``colors`` and ``radii`` are split into ``model`` equal blocks
of rows, one per model rank; ``light_dir`` and ``ambient`` are replicated.
The padded slot count divides by the model size
(DistributedTrainer._bucket), so every shard has the same rows, its slots
past the live ones masked as elsewhere (1e30 |c|², −1e30 logits). Adam runs
on each rank's own rows: its moment buffers sit beside them in
``torch.optim`` state, so they shard exactly as the rows do and the
replicated leaves' moments stay replicated.

``make_sharded_chunk_runner`` is the counterpart of the JAX package's
function of that name, which scans a chunk of whole sharded steps
(sampling, forward, loss, gradients, the data-axis pmean and Adam) inside
one ``shard_map``. Here the step is ``make_sharded_train_step``'s: the
shared step body of train/step_body.py with the mesh's axes, its gradients
and loss averaged over the data axis before Adam, so every data replica
takes the same step. The runner of its chunks is train/chunk.ChunkRunner,
as for the single-device step: where ``replays_graphs`` allows it (a CUDA
dataset, every mesh axis on NCCL) each step is a replay of a captured CUDA
graph that holds the whole sharded step, its collectives included; over a
gloo axis, whose collectives stage CUDA tensors through host memory, the
steps run one at a time. DistributedTrainer builds the same pair through
the Trainer's hooks: ``_build_step`` returns the sharded step, and
run_stage's ChunkRunner runs it with ``graphs`` from ``_replays_graphs``.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.models.scene import SceneParams
from burn_raymarching_tpu_torch.parallel.collectives import Axis, all_gather
from burn_raymarching_tpu_torch.parallel.mesh import mesh_axis
from burn_raymarching_tpu_torch.train.chunk import ChunkRunner
from burn_raymarching_tpu_torch.train.step_body import make_device_step

# The row-sharded leaves (the rest are replicated).
ROW_LEAVES = ("centers", "colors", "radii")


def shard_params(params: SceneParams, mask: torch.Tensor,
                 mesh: DeviceMesh) -> tuple[SceneParams, torch.Tensor]:
    """The whole padded table → this rank's (rows, mask) shard, as fresh
    parameters."""
    ax = mesh_axis(mesh, "model")
    m_local = params.n // ax.size
    if m_local * ax.size != params.n:
        raise ValueError(f"{params.n} rows do not split into {ax.size} "
                         f"model shards")
    rows = slice(ax.index * m_local, (ax.index + 1) * m_local)
    return (SceneParams(params.centers.detach()[rows],
                        params.colors.detach()[rows],
                        params.radii.detach()[rows],
                        params.light_dir.detach(), params.ambient.detach()),
            mask[rows])


@torch.no_grad()
def gather_params(params: SceneParams, mask: torch.Tensor,
                  mesh: DeviceMesh) -> tuple[SceneParams, torch.Tensor]:
    """Inverse of ``shard_params``: every shard's rows, in model order."""
    ax = mesh_axis(mesh, "model")
    whole = [all_gather(getattr(params, k).detach(), ax, 0)
             for k in ROW_LEAVES]
    return (SceneParams(*whole, params.light_dir.detach(),
                        params.ambient.detach()),
            all_gather(mask, ax, 0))


def make_sharded_train_step(cfg: TrainConfig, mesh: DeviceMesh, *,
                            march_normal_fn: Optional[Callable] = None,
                            culled_march_fn: Optional[Callable] = None,
                            warm: bool = False) -> Callable:
    """The step of train/step_body.make_device_step over the mesh, with the
    single-device step's call signature. ``cfg.batch_size`` is the global
    batch; each data rank samples batch / data of it. Kernels: K1 and K2
    (``march_normal_fn``) where one rank owns the whole table (model = 1);
    K3 (``culled_march_fn``) directly at model = 1 and on the union table
    above it. The repulsion is the plain version with its prep computed in
    the step, never K4 or the frozen prep, as in the JAX package's sharded
    step (both see one whole cluster table)."""
    data, model = (mesh_axis(mesh, name) for name in ("data", "model"))
    batch = cfg.batch_size // data.size
    if batch * data.size != cfg.batch_size:
        raise ValueError("batch_size must divide the data axis")
    step = make_device_step(
        cfg, march_normal_fn=march_normal_fn, batch=batch,
        culled_march_fn=culled_march_fn, repulsion_fn=None, warm=warm,
        data_axis=data if data.size > 1 else None,
        model_axis=model if model.size > 1 else None)

    def sharded_step(*args, rep_static=None, **kwargs):
        return step(*args, **kwargs)

    return sharded_step


def replays_graphs(device: torch.device, axes: Iterable[Axis]) -> bool:
    """Whether the sharded steps on ``device`` over the mesh ``axes``
    replay a captured CUDA graph: on a CUDA device when every axis runs
    NCCL. gloo stages CUDA tensors through host memory, which a graph
    cannot record, so a mesh with a gloo axis (the CPU; several ranks that
    share one card) runs its steps one at a time. A rule fixed before the
    stage starts: a capture that fails under NCCL raises."""
    return device.type == "cuda" and all(ax.backend == "nccl" for ax in axes)


def make_sharded_chunk_runner(
        cfg: TrainConfig, mesh: DeviceMesh, *, graphs: bool,
        march_normal_fn: Optional[Callable] = None,
        culled_march_fn: Optional[Callable] = None,
        warm: bool = False) -> Callable[..., ChunkRunner]:
    """The sharded step (``make_sharded_train_step`` with these arguments)
    and the runner of its chunks → ``make_runner(params, opt, lr_scales,
    stage, mask, packed, fg_pool, n_fg, generator, **kw)``, a ChunkRunner
    of that step (train/chunk.py, the same arguments) that replays a
    captured graph of the whole sharded step, collectives included, when
    ``graphs`` is set (the caller's decision; ``replays_graphs`` states
    the rule), and else runs the steps one at a time."""
    step = make_sharded_train_step(cfg, mesh,
                                   march_normal_fn=march_normal_fn,
                                   culled_march_fn=culled_march_fn, warm=warm)
    return functools.partial(ChunkRunner, step, graphs=graphs)

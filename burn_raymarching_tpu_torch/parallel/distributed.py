"""The distributed trainer (port of burn_raymarching_tpu/parallel/
distributed.py).

Topology: every rank is one process with one (data, model) coordinate of
the mesh (parallel/mesh.py), and every rank runs the same program:

  * the DATASET is sharded over the data axis: each data rank owns a
    contiguous pixel shard, its own fg index set in shard-local ids and its
    slice of the warm-start t cache, and samples its batch from it with a
    generator folded with its data index (no data exchange on the sample
    path). Shards are equal-sized, so the mean of shard means is the global
    batch mean; the fg boost applies per shard;
  * the PRIMITIVES are sharded over the model axis: each model rank trains
    one block of rows (parallel/train_step.py), Morton-sorted at stage
    start so that the shards and the consecutive cluster groups are
    spatially coherent;
  * between stages every rank holds the whole table (gathered over the
    model axis) and runs density control, evaluation and the gated rounds
    itself: the same host code on the same numbers, so the ranks agree;
  * rank 0 alone writes previews, scene.json, checkpoints and metrics.

DistributedTrainer IS the single-device Trainer (a subclass): the same
stages, anneals, density control, warm prefill, checkpoints, previews,
export, polish and refinement; only the hooks listed in train/loop.py
differ. There is no reduced second training loop. A stage runs in chunks
of ``steps_per_call`` (auto target 350, the JAX package's) through the
Trainer's run_stage, whose ChunkRunner runs the sharded step
(parallel/train_step.make_sharded_train_step, from ``_build_step``): on a
CUDA dataset over an all-NCCL mesh each step replays a captured CUDA graph
of the whole sharded step, its collectives included; over gloo the steps
run one at a time (parallel/train_step.replays_graphs). The trainer
decides which at construction, logs it once and records it in ``events``
(kind "graphs").
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from burn_raymarching_tpu_torch.config import TrainConfig
from burn_raymarching_tpu_torch.data.dataset import (
    RayDataset,
    compute_fg_indices,
)
from burn_raymarching_tpu_torch.models.scene import SceneParams
from burn_raymarching_tpu_torch.ops.culling import (
    PrimitiveClusters,
    morton_order,
)
from burn_raymarching_tpu_torch.parallel.mesh import (
    is_host0,
    make_mesh,
    mesh_axis,
)
from burn_raymarching_tpu_torch.parallel.train_step import (
    gather_params,
    make_sharded_train_step,
    replays_graphs,
    shard_params,
)
from burn_raymarching_tpu_torch.train.loop import Trainer, fold_key
from burn_raymarching_tpu_torch.train.step_body import culled_march_backend
from burn_raymarching_tpu_torch.utils import bucket_size
from burn_raymarching_tpu_torch.utils.profiling import annotate


class ShardedRayDataset:
    """A RayDataset laid out for a (data, model) mesh: ``packed``, the fg
    index sets and ``tile_fg`` are this data rank's contiguous pixel shard
    (shard-local ids, padded to the shard's pixel count like
    compute_fg_indices); ``rays_o`` / ``rays_d`` / ``targets``,
    ``num_total_pixels`` and the fg counts describe the whole dataset, as
    the JAX package's global arrays do. The pixel count must divide the
    data axis (views × H × W does for every real configuration)."""

    def __init__(self, ds: RayDataset, mesh, fg_threshold: float = 0.05):
        data = mesh_axis(mesh, "data")
        p_total = ds.num_total_pixels
        if p_total % data.size:
            raise ValueError(f"total pixels ({p_total}) must divide the data "
                             f"axis ({data.size})")
        self.base = ds
        self.fg_threshold = fg_threshold
        self.num_total_pixels = p_total
        self.p_local = p_total // data.size
        self.num_fg, self.num_bg = ds.num_fg, ds.num_bg
        lo = data.index * self.p_local
        self.packed = ds.packed[lo:lo + self.p_local]
        self.rays_o, self.rays_d = ds.rays_o, ds.rays_d
        self.targets = ds.targets
        fg, self.num_fg_local = compute_fg_indices(
            self.packed[:, 6:9].cpu().numpy(), fg_threshold)
        self.fg_indices = torch.as_tensor(fg, device=ds.device)

    @property
    def device(self) -> torch.device:
        return self.base.device

    def local_rays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """This shard's (rays_o, rays_d)."""
        return self.packed[:, 0:3], self.packed[:, 3:6]

    def tile_fg(self, tile: int) -> tuple[torch.Tensor, int]:
        """This shard's tile-granular fg split (RayDataset.tile_fg)."""
        if self.p_local % tile:
            raise ValueError(f"local pixels ({self.p_local}) must divide by "
                             f"tile ({tile})")
        px = self.packed[:, 6:9].cpu().numpy().sum(axis=1)
        any_fg = (px > self.fg_threshold).reshape(-1, tile).any(axis=1)
        ids = np.nonzero(any_fg)[0].astype(np.int32)
        padded = np.zeros((any_fg.shape[0],), np.int32)
        padded[: ids.size] = ids
        return torch.as_tensor(padded, device=self.device), int(ids.size)


class DistributedTrainer(Trainer):
    """The Trainer over a (data, model) mesh of an initialized process
    group (parallel/mesh.init_distributed). ``dataset`` is the whole
    dataset, on this rank's device. The mesh's construction is the span
    ``trainer.mesh`` (data, model, backend)."""

    def __init__(self, cfg: TrainConfig, dataset: RayDataset,
                 data: Optional[int] = None, model: int = 1,
                 log: Callable[[str], None] = print):
        with annotate("trainer.mesh") as attrs:
            self.mesh = make_mesh(data=data, model=model)
            self.data_axis = mesh_axis(self.mesh, "data")
            self.model_axis = mesh_axis(self.mesh, "model")
            self.model, self.n_data = (self.model_axis.size,
                                       self.data_axis.size)
            axes = (self.data_axis, self.model_axis)
            backend = "/".join(sorted({ax.backend for ax in axes}))
            attrs.update(data=self.n_data, model=self.model,
                         backend=backend)
        tiles = cfg.batch_size // self.n_data // cfg.cull_tile
        if cfg.use_culling and self.model > 1 and tiles % self.model:
            raise ValueError(
                f"the {tiles} tiles of a rank's batch do not split over the "
                f"{self.model} model ranks of the union-table march")
        self._io = is_host0()
        sharded = ShardedRayDataset(dataset, self.mesh,
                                    fg_threshold=cfg.fg_pixel_threshold)
        super().__init__(cfg, sharded,
                         log=log if self._io else (lambda s: None))
        # Pixel-mode sampling reads this shard's own fg set.
        if cfg.sample_mode != "tile":
            self._sample_fg = (sharded.fg_indices, sharded.num_fg_local)
        self._graphs = replays_graphs(self.device, axes)
        graphs = self._replays_graphs()      # what run_stage will read
        self.events.append(dict(kind="graphs", graphs=graphs,
                                backend=backend,
                                mesh=[self.n_data, self.model]))
        self.log(f"Sharded steps over a {self.n_data}x{self.model} {backend} "
                 f"mesh: " + ("each a replay of a captured CUDA graph"
                              if graphs else "one at a time"))

    def _cluster_features(self) -> bool:
        cfg = self.cfg
        return ((cfg.use_culling and cfg.cull_hierarchical)
                or cfg.cluster_repulsion)

    # --- step construction -------------------------------------------- #

    def _chunk_target(self) -> int:
        """The JAX package's sharded auto steps_per_call: each of its chunk
        boundaries cost ~31 ms, and 350 steps a call kept the overhead
        under 10% (its config.steps_per_call)."""
        return 350

    def _replays_graphs(self) -> bool:
        """Decided at construction, by backend (train_step.replays_graphs):
        graphs on a CUDA dataset when every mesh axis runs NCCL; over gloo,
        whose host staging a graph cannot record, one step at a time."""
        return self._graphs

    def _build_step(self, render_overrides=None):
        # K1 marches a whole table and has no union form: the model-sharded
        # dense step is the plain sharded march (no kernel exists for it, in
        # either package); the culled step runs K3 on the union table.
        dense_kernel = self.model == 1 or self.cfg.use_culling
        return make_sharded_train_step(
            self._stage_cfg(render_overrides), self.mesh,
            march_normal_fn=self.march_normal_fn if dense_kernel else None,
            culled_march_fn=self.culled_march_normal_fn, warm=self.warm)

    def _warm_gate(self) -> bool:
        # The culled path warms everywhere (the union-table march or the
        # plain sharded one); the dense warm start needs K1 on one table.
        return bool(self.cfg.warm_start and self.cfg.use_culling)

    def _stage_generator(self, key: np.ndarray) -> torch.Generator:
        # A 1-wide data axis samples exactly like the single-device
        # trainer (no fold): the equivalence the tests rely on.
        if self.n_data > 1:
            key = fold_key(key, self.data_axis.index)
        return super()._stage_generator(key)

    def _culled_march(self, b_t: int) -> Callable:
        return culled_march_backend(
            self.culled_march_normal_fn, b_t,
            self.model_axis if self.model > 1 else None)

    def _march_tile_quantum(self) -> int:
        return self.model

    # --- layout hooks --------------------------------------------------- #

    def _bucket(self, n: int) -> int:
        """The bucket splits into equal model shards; cluster features need
        whole G-groups per shard, so that every cluster's members live in
        one shard."""
        quantum = self.model
        if self._cluster_features():
            quantum *= self.cfg.cull_cluster_group
        b = bucket_size(n)
        while b % quantum:
            b *= 2
        return b

    def _place(self, padded: SceneParams, mask: torch.Tensor):
        if self.model == 1:
            return padded, mask
        return shard_params(padded, mask, self.mesh)

    def _gather(self, padded: SceneParams, mask: torch.Tensor):
        if self.model == 1:
            return padded, mask
        return gather_params(padded, mask, self.mesh)

    def _init_t_cache(self) -> torch.Tensor:
        return torch.zeros((self.dataset.p_local,), dtype=torch.float32,
                           device=self.device)

    def _prefill_rays(self):
        return self.dataset.local_rays()

    def _global_dataset(self) -> RayDataset:
        return self.dataset.base

    def _prepare_stage_params(self, params: SceneParams) -> SceneParams:
        """Morton-sort the rows at stage start (a pure reordering), so that
        consecutive G-groups (the step's cluster table) and the model
        shards are spatially coherent."""
        if not (self._cluster_features() or self.model > 1):
            return params
        order = torch.as_tensor(morton_order(
            params.centers.detach().cpu().numpy()), device=self.device)
        return SceneParams(params.centers.detach()[order],
                           params.colors.detach()[order],
                           params.radii.detach()[order],
                           params.light_dir.detach(),
                           params.ambient.detach())

    def _build_cluster_table(self, padded: SceneParams, mask: torch.Tensor
                             ) -> Optional[PrimitiveClusters]:
        """Consecutive G-groups of this shard's rows, in its own row ids.
        The rows are Morton-sorted with the pad at the end
        (_prepare_stage_params, pad_params), so the grouping is
        build_clusters' while every cluster stays inside one shard (bucket
        quantum model × G)."""
        if not self._cluster_features():
            return None
        g = self.cfg.cull_cluster_group
        m_local = padded.n
        return PrimitiveClusters(
            torch.arange(m_local, device=self.device).reshape(-1, g),
            mask.bool().reshape(-1, g))

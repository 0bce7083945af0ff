"""The steps of one stage, plainly or as a captured CUDA graph (port of the
JAX package's Trainer._build_step → run_chunk, train/loop.py).

The JAX package runs ``steps_per_call`` training steps as one device
program: ``lax.scan`` over the step inside one ``jax.jit``, the anneals
computed in-graph from the step index. Here ``ChunkRunner.run(first, n)``
runs steps ``first`` .. ``first + n - 1`` of a stage in one of two ways:

* plainly, one step at a time through the step closure: the CPU (CUDA
  graphs do not exist there), the sharded trainer over a gloo mesh (gloo
  stages CUDA tensors through host memory, which a graph cannot record;
  parallel/train_step.replays_graphs), and the reference that the tests
  hold the graph against;
* by replaying a CUDA graph that holds ``unroll`` whole steps (sampling,
  the march, the shade tail, the loss, backward and Adam; in the sharded
  step over NCCL also its collectives: the model axis's all-to-all,
  all-gathers, sums and maxima, and the data axis's all-reduce of the
  gradients and the loss), captured at the runner's first call: no host
  work per step beyond the replay.

A graph reads its inputs from fixed addresses, so everything a step reads
and the host changes between steps is a static buffer, updated in place
and never rebound:

* the parameters, their gradients and Adam's moments and step counts (the
  steps update them; the gradients are the graph's own buffers);
* ``step``: the stage-relative step (plus polish's offset) as an int64
  tensor, which each recorded step advances by one before it runs, so the
  schedule (step_body.device_schedule) follows it;
* the sampling generator's seed and offset: the generator (the stage's,
  folded with the data index in a sharded trainer) is registered with the
  graph, and each replay draws the next indices of its stream;
* the warm-start t cache (Trainer.t_cache; a sharded trainer's holds its
  data rank's pixel shard), which prefill_t_cache fills in place at the
  stage start and the steps update in place;
* ``rep_static``: the repulsion's frozen tables, overwritten in place by
  ``refresh_static`` at every chunk start (the JAX package rebuilds them
  at the start of each ``run_chunk``);
* ``idx``: [unroll, B] batch indices that the caller injects (tests),
  written before each replay;
* the optimizer groups' learning-rate tensors, which every step writes;
* ``loss``: the loss of the last step run.

Capture: one plain step runs on a side stream first (it creates Adam's
state and whatever else a first call allocates); every buffer it changed
is then put back, so the warm-up trains nothing; then the graph records
``unroll`` steps on the same stream. In a sharded step the warm-up also
runs every collective of the step once on each mesh subgroup: NCCL
creates a subgroup's communicator at its first collective and cannot do
so inside a capture, so the warm-up is what makes the recorded
collectives possible. A capture that fails raises: the card never falls
back to the plain loop.

Launch counts: a replay launches the kernels its capture recorded without
calling their wrappers, so the runner takes the capture's recordings back
off the wrappers' counts (ops/cuda/build.COUNTED) and adds them, times the
replays, once per ``run``.

Tracing (utils/profiling): ``trainer.capture`` spans the whole capture
(its attributes: the capture id, the stage and the table's ``rows``) and
``trainer.replay`` one ``run``'s replays; the step's own phases
(``step.sample`` .. ``step.adam``) run as Python only at capture, where the
tracer records the graph's phase map; the warm-up step, undone, is not
traced.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from burn_raymarching_tpu_torch.models.scene import SceneParams
from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.train.optimizer import set_group_lrs
from burn_raymarching_tpu_torch.utils.profiling import TRACER, annotate


class ChunkRunner:
    """The steps of one stage with fixed parameters, optimizer, pools,
    cluster table and t cache. ``graphs`` replays a captured CUDA graph of
    ``unroll`` steps (the dataset must be on the card); otherwise steps
    run one at a time. ``step_offset`` shifts the step index the anneals
    see (polish). ``idx_fn(step)`` injects the batch indices of a step."""

    def __init__(self, step_fn: Callable, params: SceneParams,
                 opt: torch.optim.Optimizer, lr_scales: dict, stage: int,
                 mask: torch.Tensor, packed: torch.Tensor,
                 fg_pool: torch.Tensor, n_fg: int,
                 generator: torch.Generator,
                 t_cache: Optional[torch.Tensor] = None, clusters=None,
                 idx_fn: Optional[Callable[[int], torch.Tensor]] = None,
                 step_offset: int = 0, unroll: int = 1,
                 graphs: bool = False):
        if unroll < 1:
            raise ValueError(f"scan_unroll must be >= 1, got {unroll}")
        self.step_fn, self.params, self.opt = step_fn, params, opt
        self.lr_scales, self.stage, self.mask = lr_scales, stage, mask
        self.packed, self.fg_pool, self.n_fg = packed, fg_pool, n_fg
        self.generator, self.t_cache = generator, t_cache
        self.clusters, self.idx_fn = clusters, idx_fn
        self.unroll, self.graphs = unroll, graphs
        self.rep_static = None
        self.idx = None
        self.step = torch.full((), step_offset, dtype=torch.int64,
                               device=packed.device)
        self.loss = torch.zeros((), dtype=torch.float32,
                                device=packed.device)
        self.graph = None
        self.capture_id = None
        # {wrapper: kernel launches one replay makes}
        self.per_replay: dict = {}

    def refresh_static(self, rep_static) -> None:
        """New frozen repulsion tables: written into the captured ones once
        a graph reads them, bound before that."""
        if self.graph is None or self.rep_static is None:
            self.rep_static = rep_static
            return
        for dst, src in zip(self.rep_static, rep_static):
            dst.copy_(src)

    def _one(self, idx: Optional[torch.Tensor]) -> None:
        """One whole step: advance the step index, sample, forward, loss,
        backward, learning rates, Adam."""
        TRACER.count("steps")
        with annotate("step.sample"):
            self.step += 1
        loss, lr = self.step_fn(
            self.params, self.generator, self.stage, self.step, self.mask,
            self.packed, self.fg_pool, self.n_fg, idx=idx,
            t_cache=self.t_cache, clusters=self.clusters,
            rep_static=self.rep_static)
        with annotate("step.adam"):
            set_group_lrs(self.opt, lr, self.lr_scales)
            self.opt.step()
            self.loss.copy_(loss)

    def run(self, first: int, n: int) -> None:
        """Steps ``first`` .. ``first + n - 1`` (1-based within the
        stage)."""
        if not self.graphs:
            for s in range(first, first + n):
                self._one(None if self.idx_fn is None else self.idx_fn(s))
            return
        if n % self.unroll:
            raise ValueError(f"{n} steps do not divide into graphs of "
                             f"scan_unroll = {self.unroll} steps")
        if self.graph is None:
            self._capture(first)
        replays = n // self.unroll
        with annotate("trainer.replay", capture=self.capture_id,
                      replays=replays):
            for s in range(first, first + n, self.unroll):
                if self.idx_fn is not None:
                    for i in range(self.unroll):
                        self.idx[i].copy_(self.idx_fn(s + i))
                self.graph.replay()
        TRACER.replayed(self.capture_id, replays)
        for fn, d in self.per_replay.items():
            fn.launches += d * replays

    def snapshot(self) -> dict:
        """Copies of what a step changes."""
        return {"params": [p.detach().clone()
                           for p in self.params.parameters()],
                "t_cache": (None if self.t_cache is None
                            else self.t_cache.clone()),
                "generator": self.generator.get_state(),
                "step": self.step.clone()}

    @torch.no_grad()
    def restore(self, saved: dict) -> None:
        """Put back what ``snapshot`` copied; Adam's state to its start.
        After a capture the graph replays from the restored buffers."""
        for p, s in zip(self.params.parameters(), saved["params"]):
            p.copy_(s)
        if self.t_cache is not None:
            self.t_cache.copy_(saved["t_cache"])
        self.generator.set_state(saved["generator"])
        self.step.copy_(saved["step"])
        for state in self.opt.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    v.zero_()
        self.params.zero_grad(set_to_none=True)

    def _capture(self, first: int) -> None:
        with annotate("trainer.capture", stage=self.stage,
                      rows=self.mask.numel()) as attrs:
            self._record(first)
            attrs["capture"] = self.capture_id

    def _record(self, first: int) -> None:
        dev = self.packed.device
        if self.idx_fn is not None:
            idx0 = self.idx_fn(first)
            self.idx = torch.empty((self.unroll,) + tuple(idx0.shape),
                                   dtype=idx0.dtype, device=dev)
            self.idx[0].copy_(idx0)
        saved = self.snapshot()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with TRACER.paused(), torch.cuda.stream(side):
            self._one(None if self.idx is None else self.idx[0])
        torch.cuda.current_stream(dev).wait_stream(side)
        self.restore(saved)
        if TRACER.on:
            TRACER.device_counter(dev)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = build.launch_counts()
        with torch.cuda.graph(graph, stream=side), \
                TRACER.capture(side) as self.capture_id:
            for i in range(self.unroll):
                self._one(None if self.idx is None else self.idx[i])
        after = build.launch_counts()
        self.per_replay = {fn: after[fn] - before[fn] for fn in after
                           if after[fn] != before[fn]}
        for fn, d in self.per_replay.items():
            fn.launches -= d
        self.graph = graph

    def close(self) -> None:
        """Free the graph and its memory pool (the gradients live there)
        before the next stage captures its own."""
        self.graph = None
        self.params.zero_grad(set_to_none=True)

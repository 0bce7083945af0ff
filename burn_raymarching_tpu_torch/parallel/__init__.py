"""Sharded training on torch.distributed (port of burn_raymarching_tpu/
parallel/): collectives with shard_map semantics, the ("data", "model")
mesh, the sharded step and DistributedTrainer. Import the submodules
directly; this package file imports none of them, so that the ops and
renderers can import the collectives without a cycle."""

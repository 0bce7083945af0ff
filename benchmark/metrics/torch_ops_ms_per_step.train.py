"""torch_ops_ms_per_step.train (ms): device-busy time inside the program's
ChunkRunner.run calls that is neither a hand kernel (K1-K4) nor NCCL, per
training step of the traced slice: the step's PyTorch operations."""

from benchmark.harness.devtrace import HAND_KERNELS, union_us

HAND = tuple(n for names in HAND_KERNELS.values() for n in names)


def read(run):
    if not run.slice_steps:
        return None
    evs = [e for e in run.events.inside("chunk")
           if not any(h in e[2] for h in HAND) and "nccl" not in e[2].lower()]
    return union_us(evs) / 1000.0 / run.slice_steps

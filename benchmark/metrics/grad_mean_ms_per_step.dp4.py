"""grad_mean_ms_per_step.dp4 (ms): device time of the captured step's
``step.grad_mean`` phase on rank 0 (``collectives.mean_grads``: the
flattened gradients and the loss, their NCCL all-reduce over the data
axis, the division and the copies back) per step replayed in the traced
slice, from the capture's phase map; nothing where the program's step has
no such phase."""

from benchmark.harness import progtrace


def read(run):
    got = progtrace.phase_times(run)
    if got is None or "step.grad_mean" not in got["phases"]:
        return None
    return progtrace.phase_ms_per_step(run, "step.grad_mean")

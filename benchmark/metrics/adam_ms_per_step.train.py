"""adam_ms_per_step.train (ms): device time of the captured step's
``step.adam`` phase (the learning rates, the fused Adam step and the loss
copy) per step replayed in the traced slice, from the capture's phase
map."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.phase_ms_per_step(run, "step.adam")

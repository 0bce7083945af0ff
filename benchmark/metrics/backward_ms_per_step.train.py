"""backward_ms_per_step.train (ms): device time of the captured step's
``step.backward`` phase (autograd's backward of the tail, the loss and the
repulsion) per step replayed in the traced slice, from the capture's
phase map."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.phase_ms_per_step(run, "step.backward")

"""select_ms_per_step.train (ms): device time of the captured step's
``step.select`` phase (the batch's sort and gather, the detached
activation and the per-tile selection, ``culled_tables``) per step
replayed in the traced slice, from the capture's phase map."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.phase_ms_per_step(run, "step.select")

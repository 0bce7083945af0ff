"""tail_ms_per_step.train (ms): device time of the captured step's
``step.tail`` phase (the forward of the shading tail: render_diff_culled,
shade_fused or scene_forward) per step replayed in the traced slice, from
the capture's phase map."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.phase_ms_per_step(run, "step.tail")

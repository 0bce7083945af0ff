"""step_mfu.train (%): the least time the card needs for the traced slice's
training steps (counts.py: the march over the live or valid pairs, the
shading tail, the repulsion) over the slice's wall time, stage boundaries
included."""


def read(run):
    if not run.slice_steps:
        return None
    return 100.0 * run.step_work().least_s(run.peaks) / run.events.window_s

"""host_launches_per_step.train (calls): the host's launch calls (kernel
launches, graph launches, copies, memsets) in the traced slice per
training step run in it, stage boundaries included."""


def read(run):
    if not run.slice_steps:
        return None
    return run.events.launches_in_slice() / run.slice_steps

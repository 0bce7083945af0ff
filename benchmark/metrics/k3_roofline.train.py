"""k3_roofline.train (%): K3's least time for the culled march of the
traced slice's steps (rays x valid table slots, counted on the device as
the steps build their tables, x (march steps + 7) field evaluations) over
its device time inside the steps (the stage-start prefill's cold launches
are left out)."""

from benchmark.harness import counts
from benchmark.harness.devtrace import HAND_KERNELS


def read(run):
    if not run.culled:
        return None
    t = run.events.kernel_s(HAND_KERNELS["K3"], within="chunk")
    if t <= 0 or run.slice_valid <= 0:
        return None
    work = counts.march(run.march_pairs(), run.march_steps)
    return 100.0 * work.least_s(run.peaks) / t

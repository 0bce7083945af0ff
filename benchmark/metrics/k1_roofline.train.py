"""k1_roofline.train (%): K1's least time for the dense march of the
traced slice's steps (rays x live slots x (march steps + 7) field
evaluations) over its device time (march and pack kernels) inside the
steps."""

from benchmark.harness import counts
from benchmark.harness.devtrace import HAND_KERNELS


def read(run):
    if run.culled:
        return None
    t = run.events.kernel_s(HAND_KERNELS["K1"], within="chunk")
    if t <= 0:
        return None
    work = counts.march(run.march_pairs(), run.march_steps)
    return 100.0 * work.least_s(run.peaks) / t

"""k2_roofline.train (%): K2's least time for the shading tail of the
traced slice's steps (forward and backward, 5 + 5 SFU operations a (ray,
live slot) pair) over its device time (pack, forward and backward
kernels) inside the steps."""

from benchmark.harness import counts
from benchmark.harness.devtrace import HAND_KERNELS


def read(run):
    if run.culled:
        return None
    t = run.events.kernel_s(HAND_KERNELS["K2"], within="chunk")
    if t <= 0:
        return None
    pairs = run.march_pairs()
    work = counts.shade_fwd(pairs) + counts.shade_bwd(pairs)
    return 100.0 * work.least_s(run.peaks) / t

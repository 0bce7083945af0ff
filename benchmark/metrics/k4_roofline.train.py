"""k4_roofline.train (%): K4's least time for the two-level repulsion of
the traced slice's steps (C·G·(W·G + C) pairs, forward and backward) over
its device time (forward and backward kernels) inside the steps."""

from benchmark.harness import counts
from benchmark.harness.devtrace import HAND_KERNELS


def read(run):
    t = run.events.kernel_s(HAND_KERNELS["K4"], within="chunk")
    if t <= 0:
        return None
    work = (counts.repulsion_fwd(run.slice_rep_pairs)
            + counts.repulsion_bwd(run.slice_rep_pairs))
    return 100.0 * work.least_s(run.peaks) / t

"""k1_roofline.view (%): K1's least time for the traced slice's frames
(rays x the scene's spheres x 47 field evaluations) over its device time
(march and pack kernels) in the slice."""

from benchmark.harness.devtrace import HAND_KERNELS


def read(run):
    t = run.events.kernel_s(HAND_KERNELS["K1"])
    if t <= 0:
        return None
    return 100.0 * run.march_work().least_s(run.peaks) / t

"""device_idle_share.train (%): 1 - device-busy time over the traced
slice's wall time; the slice holds one stage boundary."""


def read(run):
    return 100.0 * (1.0 - run.events.busy_s() / run.events.window_s)

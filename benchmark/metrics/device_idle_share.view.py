"""device_idle_share.view (%): 1 - device-busy time over the traced
slice's wall time; frames back to back."""


def read(run):
    return 100.0 * (1.0 - run.events.busy_s() / run.events.window_s)

"""frame_mfu.view (%): the least time the card needs for the traced
slice's frames (the march and the shading forward over rays x spheres,
counts.py) over the slice's wall time."""


def read(run):
    if run.slice_rays <= 0:
        return None
    return 100.0 * run.frame_work().least_s(run.peaks) / run.events.window_s

"""encode_ms_per_frame.view (ms): median host time of the preview frames'
``view.encode`` spans (gamma, uint8 and the PNG encoder)."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.frame_child_ms(run, "view.encode")

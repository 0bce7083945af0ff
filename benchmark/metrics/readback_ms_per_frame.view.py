"""readback_ms_per_frame.view (ms): median host time of the preview
frames' ``view.readback`` spans (the frame's copy to the host, where the
host waits for the card's march and tail)."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.frame_child_ms(run, "view.readback")

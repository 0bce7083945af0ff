"""upload_ms_per_frame.view (ms): median host time of the preview frames'
``view.scene_upload`` spans (the scene's copy to the card on every
frame, viewer_offline.scene_tensors)."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.frame_child_ms(run, "view.scene_upload")

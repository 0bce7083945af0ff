"""preview_share.train (%): the share of the traced run's window (less the
harness's pauses) that the host spends rendering and writing the stage
previews (the program's ``trainer.preview`` spans, Trainer.save_preview)."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.window_share(run, "trainer.preview")

"""capture_share.train (%): the share of the traced run's window (less the
harness's pauses) that the host spends capturing the step's CUDA graph
(the program's ``trainer.capture`` spans: ChunkRunner._capture, its
warm-up step, the restore and the recording)."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.window_share(run, "trainer.capture")

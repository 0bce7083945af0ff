"""prefill_share.train (%): the share of the traced run's window (less the
harness's pauses) that the host spends in the stage-start cold march that
fills the warm start's t cache (the program's ``trainer.prefill`` spans,
Trainer.prefill_t_cache)."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.window_share(run, "trainer.prefill")

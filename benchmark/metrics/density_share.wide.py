"""density_share.wide (%): the share of the traced run's window (less the
harness's pauses) that the host spends in density control at the stage
boundaries (the program's ``trainer.density`` spans,
Trainer._density_control: the live rows read back from the card, prune,
split and merge in NumPy, the next stage's rows copied back). At config 5
the first boundary reads 51,200 rows and merges them ~20x."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.window_share(run, "trainer.density")

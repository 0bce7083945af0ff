"""cull_fill.train (%): the valid entries of the steps' culled tables (the
program's device counter ``valid_entries``) over their slots (the host
counter ``table_slots``: tiles × the culling budget), over every step
counted since the tracer was switched on: set-up's checked steps and every
job of the run, not the window's steps alone, so a longer window (whose
later stages' tables fill less) reads lower."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.cull_fill(run)

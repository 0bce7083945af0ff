"""boundary_share.train (%): the share of the traced run's window that the
host spends outside the program's ChunkRunner.run calls (stage
boundaries: prefill, cluster tables, graph capture, density control,
previews, checkpoints, export), from the harness's spans; the time the
harness itself spends starting and stopping the profiler is left out."""


def read(run):
    lo, hi = run.window
    total = (hi - lo) - run.spans.seconds("pause", lo, hi)
    if total <= 0:
        return None
    return 100.0 * (1.0 - run.spans.seconds("chunk", lo, hi) / total)

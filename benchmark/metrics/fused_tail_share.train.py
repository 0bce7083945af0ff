"""fused_tail_share.train (%): the culled steps whose gradient-carrying tail
ran as the fused kernels (the program's counter ``tail.fused``) over every
culled step counted (``tail.fused`` + ``tail.plain``), since the tracer was
switched on: set-up's checked steps and every job of the run. None where
the program counts neither (a program without the counters)."""

from benchmark.harness import progtrace


def read(run):
    rec = progtrace.records(run)
    if rec is None:
        return None
    c = rec["counters"]
    fused, plain = c.get("tail.fused", 0), c.get("tail.plain", 0)
    if fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)

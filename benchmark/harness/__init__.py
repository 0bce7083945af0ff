"""The benchmark's harness (``benchmark/run.py`` is the entry point).

A traced run (``benchmark/run.py ... --trace 1``) switches the program's
tracer on here, when the command first imports the harness and so before
set-up's first call into the program: the per-layer metrics that
``progtrace.py`` reads then find the program's spans, counters and phase
maps of the whole run. ``--trace`` is read as ``harness/main.py`` reads it
(a whole number, traced when 1). An untraced run, a program without the
tracer and an in-process ``main([...])`` call are left as they are; a
traced run that finds no program records says so on standard error
(``progtrace.records``).
"""

import argparse
import os
import sys


def _traced_command(argv: list) -> bool:
    """Whether ``argv`` is ``benchmark/run.py`` with ``--trace 1``."""
    script = os.path.abspath(argv[0]) if argv else ""
    if (os.path.basename(script) != "run.py"
            or os.path.basename(os.path.dirname(script)) != "benchmark"):
        return False
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False,
                                exit_on_error=False)
    p.add_argument("--trace", type=int, default=0)
    try:
        return p.parse_known_args(argv[1:])[0].trace == 1
    except argparse.ArgumentError:
        return False  # main.py refuses the command line


if _traced_command(sys.argv):
    try:
        from burn_raymarching_tpu_torch.utils.profiling import TRACER
    except ImportError:
        TRACER = None
    if TRACER is not None:
        TRACER.reset()
        TRACER.enable()

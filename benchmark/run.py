"""The benchmark of burn_raymarching_tpu_torch on NVIDIA GPUs.

Run one cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; last in it, ``checks``: each number
compared with the plain reference beside its limit (also the last lines of
standard error). Without enough CUDA devices for the cell it prints no
result and exits 2. ``--readings control,half_batch,skip_merge`` (training
cells) or ``--readings control,altered`` (the viewer) prints the check
numbers of the lower-precision control and of planted faults instead of
running.

The cells, configurations, traffic mixes, per-layer metrics and limits are
data: ``BENCHMARK.json`` names them and ``benchmark/harness/manifest.py``
finds their files by name. The CPU tests are under ``benchmark/tests``:
``python -m pytest benchmark/tests``.
"""

import os
import sys

if __name__ == "__main__":
    # One process with few threads: the CPU work on the timed paths is
    # Python, NumPy and zlib on one thread, and idle pool threads that spin
    # only add noise on a host whose cores are shared.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.harness.main import main

    sys.exit(main())

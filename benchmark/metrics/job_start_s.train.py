"""job_start_s.train (s): the median over the window's jobs of the host
seconds from a job's ``trainer.run`` to its first ``trainer.replay``: its
init and padding, the first stage's prefill and cluster tables, the first
chunk's repulsion tables and the first capture."""

from benchmark.harness import progtrace


def read(run):
    return progtrace.job_start_s(run)

"""allreduce_roofline.dp4 (%): the gradient all-reduce's share of its
roofline on rank 0 over the traced slice's replayed steps
(``harness/allreduce.py``): the bus bytes a ring all-reduce of
``grad_mean.bytes`` moves, 2(n - 1)/n of them, at the card's one-way
NVLink bandwidth, over the time of the NCCL kernels in the captured
step's ``step.grad_mean`` phase."""

from benchmark.harness import allreduce


def read(run):
    return allreduce.roofline(run)

"""Primitive-count padding buckets.

Density control changes M every stage. Padding M to the next bucket keeps
the table shapes (and with them the optimizer state and the kernels' staged
tables) to O(log M) distinct sizes over a whole run, as in the JAX package,
while masked soft-min/softmax keep semantics exact.
"""

from __future__ import annotations


def bucket_size(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket ≥ n (≥ ``minimum``).

    Power-of-two buckets mean at most one new shape per doubling.
    """
    if n <= minimum:
        return minimum
    b = minimum
    while b < n:
        b *= 2
    return b

"""The JAX package's JAX-free utilities, re-exported unchanged.

``burn_raymarching_tpu.utils`` holds NumPy and standard-library code only
(power-of-two padding buckets, Morton pixel orders, the metrics logger), so
the port reuses it instead of copying it. This module is the one place the
port reaches for it.
"""

from burn_raymarching_tpu.utils.metrics import MetricsLogger  # noqa: F401
from burn_raymarching_tpu.utils.morton import (  # noqa: F401
    morton_permutation,
    multi_view_morton_permutation,
)
from burn_raymarching_tpu.utils.padding import bucket_size  # noqa: F401

"""NumPy and standard-library helpers of the port (its own copies of the JAX
package's ``utils``: padding buckets, Morton pixel orders, the metrics
logger). tests/test_torch_config_utils.py holds them against the originals.
"""

from burn_raymarching_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
from burn_raymarching_tpu_torch.utils.morton import (  # noqa: F401
    morton_permutation,
    multi_view_morton_permutation,
)
from burn_raymarching_tpu_torch.utils.padding import bucket_size  # noqa: F401

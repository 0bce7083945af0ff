"""The check that nothing the benchmark runs has loaded JAX or the JAX
package. A module is compared by its top-level name (the part before the
first dot), whole: ``burn_raymarching_tpu_torch`` is the program and is
allowed, ``burn_raymarching_tpu`` is the JAX package and is not."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "burn_raymarching_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process)."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN)

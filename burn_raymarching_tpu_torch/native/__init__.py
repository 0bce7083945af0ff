"""ctypes bindings for the native C++ host helpers (port of
burn_raymarching_tpu/native): density control and threaded ray generation,
built with g++ at first use (see lib.py)."""

from burn_raymarching_tpu_torch.native.lib import (  # noqa: F401
    camera_rays_native,
    is_available,
    prune_and_split_native,
)

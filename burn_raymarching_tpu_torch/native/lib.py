"""Build and load the native host library; typed wrappers (port of
burn_raymarching_tpu/native/lib.py).

``burn_native.cpp`` here is a byte-equal copy of the repository's
``native/burn_native.cpp`` (tests/test_torch_native.py holds them equal).
At first use it is built with g++ into ``burn_raymarching_tpu_torch/build/``
under a name keyed by a hash of the source and the flags, as
ops/cuda/build.py builds the kernels; ``native/libburn_native.so`` is never
written. A failed build raises when a function is called;
``is_available()`` only reports whether the library loads.

The port's training path does not call these: it makes its rays on the
device (data/camera.py) and runs density control in NumPy
(train/density.py), the versions the tests hold these functions against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from burn_raymarching_tpu_torch.config import DensityConfig

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "native", "burn_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_error: Optional[Exception] = None


class _DensityRules(ctypes.Structure):
    _fields_ = [
        ("prune_min_radius", ctypes.c_float),
        ("prune_max_radius_base", ctypes.c_float),
        ("prune_max_radius_decay", ctypes.c_float),
        ("prune_flyaway_dist_sq", ctypes.c_float),
        ("prune_black_color_sum", ctypes.c_float),
        ("split_radius_base", ctypes.c_float),
        ("split_radius_decay", ctypes.c_float),
        ("split_move_dist", ctypes.c_float),
        ("split_child_radius_scale", ctypes.c_float),
        ("split_child_min_radius", ctypes.c_float),
    ]


def _build() -> str:
    """Compile the source (if this hash of it is not built yet) → the
    library's path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libburn_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC, "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    """The loaded library; raises the build's error (every call after a
    failed build raises it again)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(_build())
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = e
            else:
                f32p = ctypes.POINTER(ctypes.c_float)
                i32p = ctypes.POINTER(ctypes.c_int)
                lib.prune_and_split_native.restype = ctypes.c_int
                lib.prune_and_split_native.argtypes = [
                    f32p, f32p, f32p, f32p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_uint64, ctypes.POINTER(_DensityRules),
                    f32p, f32p, f32p, f32p, i32p,
                ]
                lib.camera_rays_native.restype = None
                lib.camera_rays_native.argtypes = [
                    ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_float,
                    f32p, f32p, ctypes.c_int,
                ]
                _lib = lib
        if _error is not None:
            raise RuntimeError(f"native library unavailable: {_error}")
        return _lib


def is_available() -> bool:
    """Whether the library builds and loads (builds it at the first call)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def prune_and_split_native(
    raw_centers: np.ndarray,
    raw_colors: np.ndarray,
    raw_radii: np.ndarray,
    init_centers: np.ndarray,
    stage: int,
    stages: int,
    seed: int = 0,
    cfg: DensityConfig = DensityConfig(),
    dirs: Optional[np.ndarray] = None,
):
    """C++ density control → (centers, colors, radii, stats dict).

    ``dirs`` ([M,3]) injects split directions (for exact cross-checks against
    the NumPy implementation); None draws from the library's own RNG.
    """
    lib = _load()
    m = int(np.asarray(raw_centers).reshape(-1, 3).shape[0])
    c = np.ascontiguousarray(raw_centers, np.float32).reshape(m, 3)
    col = np.ascontiguousarray(raw_colors, np.float32).reshape(m, 3)
    r = np.ascontiguousarray(raw_radii, np.float32).reshape(m)
    init = np.ascontiguousarray(init_centers, np.float32).reshape(m, 3)
    rules = _DensityRules(
        cfg.prune_min_radius, cfg.prune_max_radius_base,
        cfg.prune_max_radius_decay, cfg.prune_flyaway_dist_sq,
        cfg.prune_black_color_sum, cfg.split_radius_base,
        cfg.split_radius_decay, cfg.split_move_dist,
        cfg.split_child_radius_scale, cfg.split_child_min_radius,
    )
    out_c = np.empty((2 * m, 3), np.float32)
    out_col = np.empty((2 * m, 3), np.float32)
    out_r = np.empty((2 * m,), np.float32)
    stats = np.zeros((5,), np.int32)
    d = None
    if dirs is not None:
        d = np.ascontiguousarray(dirs, np.float32).reshape(m, 3)
    d_ptr = (_fp(d) if d is not None
             else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)))
    n = lib.prune_and_split_native(
        _fp(c), _fp(col), _fp(r), _fp(init), m, stage, stages,
        ctypes.c_uint64(seed), ctypes.byref(rules), d_ptr,
        _fp(out_c), _fp(out_col), _fp(out_r),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return (
        out_c[:n].copy(), out_col[:n].copy(), out_r[:n, None].copy(),
        {"pruned_size": int(stats[0]), "pruned_flyaway": int(stats[1]),
         "pruned_black": int(stats[2]), "split": int(stats[3]),
         "kept": int(stats[4])},
    )


def camera_rays_native(width: int, height: int, eye, target, fov_deg: float,
                       num_threads: int = 0):
    """C++ threaded ray generation → (org [N,3], dir [N,3]) float32."""
    lib = _load()
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    eye = np.ascontiguousarray(eye, np.float32).reshape(3)
    target = np.ascontiguousarray(target, np.float32).reshape(3)
    out_org = np.empty((width * height, 3), np.float32)
    out_dir = np.empty((width * height, 3), np.float32)
    lib.camera_rays_native(width, height, _fp(eye), _fp(target),
                           ctypes.c_float(fov_deg), _fp(out_org),
                           _fp(out_dir), num_threads)
    return out_org, out_dir

"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each library is a plain C interface (no PyTorch headers), so nvcc takes
seconds. The build runs at first use into ``burn_raymarching_tpu_torch/build/``
under a name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Build wall time (seconds) and ptxas report (registers, shared memory,
# spills) of each library built in this process.
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set PATH to include its bin/)")
    return path


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` → ctypes library."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([src, os.path.join(CSRC_DIR, "common.cuh")]):
        with open(path, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = proc.stderr
    return ctypes.CDLL(lib_path)


def build_all(names) -> None:
    """Build (if needed) and load several libraries, one nvcc per source,
    all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(load_library, n) for n in names]:
            future.result()


def bind(lib: ctypes.CDLL, fn: str, argtypes: list, restype=ctypes.c_int):
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = restype
    return f


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# Rows per node of the kernels' fixed-order sum over blocks (SUM_TREE_FAN in
# csrc/common.cuh).
SUM_TREE_FAN = 16


def tree_nodes(rows: int) -> int:
    """Nodes of the sum tree over ``rows`` rows, all levels: the scratch
    rows and tickets that ``sum_tree`` (csrc/common.cuh) needs."""
    total = 0
    while True:
        rows = -(-rows // SUM_TREE_FAN)
        total += rows
        if rows == 1:
            return total


_TICKETS: dict = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 tickets for a kernel that sums over its
    blocks inside the launch: one buffer per device and stream, since
    launches on one stream run in order and each kernel hands its tickets
    back as zero as it found them."""
    key = (device, stream_ptr(device))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 4096),), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


# Python floats already written to the device, by (device, value): a
# wrapper called with a float pays no copy kernel after the first call.
_SCALARS: dict = {}


def device_scalar(x, device: torch.device) -> torch.Tensor:
    """A scalar kernel operand (the soft-min sharpness) as the [1] float32
    tensor on ``device`` that the kernel reads when it runs, as the TPU
    kernels read an SMEM operand: a one-element tensor on ``device`` is
    passed through as a view of its memory (what a CUDA graph replay
    re-reads); a Python float is written to the device once and the tensor
    kept for later calls with the same value (never one made during a
    graph capture, whose memory the graph owns). Nothing writes into a
    kept tensor."""
    if not torch.is_tensor(x):
        key = (device, float(x))
        t = _SCALARS.get(key)
        if t is None:
            t = torch.full((1,), float(x), dtype=torch.float32,
                           device=device)
            if not torch.cuda.is_current_stream_capturing():
                _SCALARS[key] = t
        return t
    if x.device != device or x.numel() != 1 or x.dtype != torch.float32:
        raise ValueError(f"a scalar operand must be one float32 value on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.detach().reshape(1)


# Every wrapper that launches a kernel of csrc/, in the order they are
# defined. ``fn.launches`` counts the launches of its kernel: the wrapper
# adds one per launch, and a CUDA graph replay, which launches the kernels
# its capture recorded without calling any wrapper, adds what the capture
# recorded (train/chunk.py).
COUNTED: list = []


def counted(fn):
    """Register a kernel wrapper with a launch count of 0."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """{wrapper: launches} of every counted wrapper."""
    return {fn: fn.launches for fn in COUNTED}


def check_cuda_f32(name: str, x: torch.Tensor, shape: tuple,
                   device: torch.device) -> None:
    """Validate a kernel argument: device, dtype, shape, contiguity."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_noop(device: torch.device) -> None:
    """Launch the empty kernel of csrc/noop.cu (the launch-time floor)."""
    fn = bind(load_library("noop"), "noop_launch", [ctypes.c_void_p])
    check(fn(stream_ptr(device)), "empty kernel launch")

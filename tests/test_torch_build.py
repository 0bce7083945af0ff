"""Every CUDA source under burn_raymarching_tpu_torch/csrc/ is a library of
its own (ops/cuda/build.py): on the card each one builds with nvcc, or is
found built under its hash, and loads."""

import os

import pytest
from torch_parity import cuda_device  # noqa: F401  (a fixture)

from burn_raymarching_tpu_torch.ops.cuda import build

LIBRARIES = sorted(name[:-3] for name in os.listdir(build.CSRC_DIR)
                   if name.endswith(".cu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", LIBRARIES)
def test_cuda_library_builds_and_loads(cuda_device, name):
    lib = build.load_library(name)
    assert os.path.basename(lib._name).startswith(f"lib{name}_")

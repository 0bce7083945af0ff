"""Process-group setup and the ("data", "model") device mesh (port of
burn_raymarching_tpu/parallel/mesh.py and the process helpers of
parallel/distributed.py).

The scaling axes:
  * "data"  — rays/pixels: each rank samples its own batch from its pixel
    shard; gradients are averaged over the axis before Adam.
  * "model" — primitives (the M axis): each rank holds a shard of the
    primitive rows; soft-min and softmax compositing combine shards with a
    two-pass max-then-sum logsumexp (parallel/collectives.py).

Every rank is one process with one (data, model) coordinate; rank =
data_index * model + model_index. NCCL carries the collectives between
GPUs (one GPU per rank: NCCL refuses two ranks on one GPU); gloo carries
them on the CPU, and between ranks that share a GPU (collectives.py stages
their CUDA tensors through host memory).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from burn_raymarching_tpu_torch.parallel.collectives import Axis

DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device: torch.device | str = "cuda",
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Initialize torch.distributed once per process; a no-op when it
    already is.

    Under ``torch.distributed.run`` (RANK / WORLD_SIZE / MASTER_ADDR in the
    environment) the rendezvous is ``env://``. With no ``init_method`` and
    no such environment the process is a world of one on a free localhost
    port. The backend is NCCL for a CUDA ``device`` and gloo for the CPU,
    unless ``backend`` says otherwise; with NCCL the process takes the GPU
    of its local rank."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if init_method is None:
        if "RANK" in os.environ and "MASTER_ADDR" in os.environ:
            init_method = "env://"
        else:
            init_method = f"tcp://localhost:{free_port()}"
            world_size, rank = 1, 0
    kw = {}
    if init_method != "env://":
        kw = dict(world_size=world_size, rank=rank)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def is_host0() -> bool:
    """True on the rank that writes files (rank 0, or no process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(data: Optional[int] = None, model: int = 1) -> DeviceMesh:
    """A ("data", "model") DeviceMesh over the initialized world
    (``data`` defaults to world // model)."""
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the world has {world}")
    # The mesh's device type only names where DTensors would live; gloo
    # groups are created with "cpu" so that no GPU is bound per rank.
    device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis(mesh: DeviceMesh, name: str) -> Axis:
    """One named axis of ``mesh`` as a collectives.Axis."""
    return Axis(group=mesh.get_group(name), size=mesh.size(
        mesh.mesh_dim_names.index(name)), index=mesh.get_local_rank(name),
        name=name)

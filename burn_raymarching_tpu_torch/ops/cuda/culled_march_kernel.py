"""K3: fused per-tile detached culled march + normals (port of
burn_raymarching_tpu/ops/pallas/culled_march_kernel.py::
culled_march_normals_pallas).

``culled_march_normals`` launches the CUDA kernel in csrc/culled_march.cu
for CUDA tensors and runs ``culled_march_normals_xla`` (render/culled.py,
the plain version) for CPU tensors. There is no fallback: a CUDA tensor
either goes through the kernel or raises. The kernel keeps the plain
version's op order (distance first, then ·(−k)) and sums the soft-min in
one pass; the two differ only by float32 rounding, which the 40-step march
can amplify on grazing rays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.render.culled import culled_march_normals_xla

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _launcher():
    lib = build.load_library("culled_march")
    return build.bind(lib, "culled_march_launch", [
        _P, _P, _P, _P, _I, _I, _I, _P, _I, _F, _P, _P, _P])


def culled_table(cs: torch.Tensor, rs: torch.Tensor, qs: torch.Tensor
                 ) -> torch.Tensor:
    """[B, K, 5] rows (cx, cy, cz, |c|², r), |c|² = 1e30 in invalid slots:
    one concatenation. The kernel stages it as float4 (−2cx, −2cy, −2cz,
    |c|²) + r and visits only the columns up to the last valid slot."""
    return torch.cat([cs.detach().float(), qs.detach().float()[:, :, None],
                      rs.detach().float()[:, :, None]], dim=2)


@build.counted
@torch.no_grad()
def culled_march_normals(ro3: torch.Tensor, rd3: torch.Tensor,
                         cs: torch.Tensor, rs: torch.Tensor, qs: torch.Tensor,
                         smooth_k, *, num_steps: int = 40,
                         normal_eps: float = 1e-4,
                         t_init: Optional[torch.Tensor] = None):
    """Detached culled march + normals → (t [B,T,1], normal [B,T,3]).

    ro3, rd3 [B, T, 3] tile-coherent rays; cs [B, K, 3], rs, qs [B, K] the
    gathered per-tile tables; ``t_init`` [B, T, 1] warm-starts the march.
    ``smooth_k`` is a Python float or a one-element float32 tensor on the
    rays' device, which the kernel reads when it runs.
    """
    if ro3.device.type == "cpu":
        return culled_march_normals_xla(ro3, rd3, cs, rs, qs, smooth_k,
                                        num_steps=num_steps,
                                        normal_eps=normal_eps, t_init=t_init)
    if ro3.device.type != "cuda":
        raise ValueError(f"culled_march_normals: unsupported device "
                         f"{ro3.device}")
    dev = ro3.device
    b, t_dim = ro3.shape[0], ro3.shape[1]
    k_dim = cs.shape[1]
    build.check_cuda_f32("ro3", ro3, (b, t_dim, 3), dev)
    build.check_cuda_f32("rd3", rd3, (b, t_dim, 3), dev)
    if k_dim < 1:
        raise ValueError("culled_march_normals needs at least one table slot")
    k = build.device_scalar(smooth_k, dev)
    prim = culled_table(cs, rs, qs)
    build.check_cuda_f32("prim", prim, (b, k_dim, 5), dev)
    t0 = None
    if t_init is not None:
        t0 = t_init.detach().reshape(b, t_dim, 1)
        build.check_cuda_f32("t_init", t0, (b, t_dim, 1), dev)
    t = torch.empty((b, t_dim, 1), dtype=torch.float32, device=dev)
    normal = torch.empty((b, t_dim, 3), dtype=torch.float32, device=dev)
    if b * t_dim == 0:
        return t, normal
    err = _launcher()(build.ptr(ro3), build.ptr(rd3), build.ptr(t0),
                      build.ptr(prim), b, t_dim, k_dim, build.ptr(k),
                      int(num_steps), float(normal_eps), build.ptr(t),
                      build.ptr(normal), build.stream_ptr(dev))
    build.check(err, "culled_march kernel launch")
    culled_march_normals.launches += 1
    return t, normal

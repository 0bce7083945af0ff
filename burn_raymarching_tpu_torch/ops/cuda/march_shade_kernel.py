"""K1: fused detached march + normals (port of
burn_raymarching_tpu/ops/pallas/march_shade_kernel.py::march_shade_pallas).

``march_shade`` launches the CUDA kernels in csrc/march_shade.cu for CUDA
tensors (one small kernel packs the primitive table, one marches) and runs
``march_shade_plain`` (the march of ops/march.py plus ops/sdf.scene_normal)
for CPU tensors. There is no fallback: a CUDA tensor either goes through the
kernels or raises. The march kernel folds k*r like the TPU kernel and sums
the soft-min in one pass, so it matches the plain version within a
tolerance, not bitwise.

``early_exit`` (the TPU kernel's option; no caller of either package sets
it) ends the iterations of a group of rays once none of them is live: a ray
is live while its last step was longer than ``CONV_TOL`` and its t is below
``MISS_T``. The TPU kernel votes over a 1,024-ray tile, the CUDA kernel over
a warp, and the plain version freezes every ray on its own, which is the
group of one. A ray that has converged moves by less than ``CONV_TOL`` per
further step, so on converged rays any two group sizes agree within
``early_exit_tolerance(num_steps)``; a ray that has left the scene ends at
some t >= ``MISS_T`` that depends on the group.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.ops.march import T_MAX, march
from burn_raymarching_tpu_torch.ops.sdf import scene_normal, scene_sdf

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _launchers():
    lib = build.load_library("march_shade")
    march = build.bind(lib, "march_shade_launch", [
        _P, _P, _P, _P, _I, _I, _P, _I, _F, _I, _P, _P, _P])
    pack = build.bind(lib, "march_pack_launch", [_P, _P, _P, _I, _P, _P, _P])
    return march, pack


# Early exit: a ray is live while |last step| > CONV_TOL and t < MISS_T
# (MARCH_CONV_TOL, MARCH_MISS_T in csrc/common.cuh).
CONV_TOL = 1e-5
MISS_T = 40.0


def early_exit_tolerance(num_steps: int) -> float:
    """Largest |t| gap between two early-exit marches of a converged ray
    whose voting groups differ: at most ``num_steps`` further steps, each
    under CONV_TOL."""
    return num_steps * CONV_TOL


@torch.no_grad()
def march_early_exit(ray_org, ray_dir, centers, radii, smooth_k,
                     mask: Optional[torch.Tensor] = None, num_steps: int = 40,
                     t_init: Optional[torch.Tensor] = None,
                     return_steps: bool = False):
    """The march of ops/march.py with every ray frozen once it is no longer
    live (the early exit with a voting group of one ray) → t [N, 1], or
    (t, the steps each ray took while live [N, 1]) with ``return_steps``."""
    if t_init is None:
        t = torch.zeros((ray_org.shape[0], 1), dtype=ray_org.dtype,
                        device=ray_org.device)
    else:
        t = t_init.detach().reshape(-1, 1).to(ray_org.dtype)
    live = torch.ones_like(t, dtype=torch.bool)
    steps = torch.zeros_like(t)
    for _ in range(num_steps):
        sm = scene_sdf(ray_org + ray_dir * t, centers, radii, smooth_k,
                       mask=mask)
        t_new = torch.clamp(t + sm, max=T_MAX)
        steps += live
        t = torch.where(live, t_new, t)
        live = live & (sm.abs() > CONV_TOL) & (t_new < MISS_T)
    return (t, steps) if return_steps else t


@torch.no_grad()
def march_shade_plain(ray_org, ray_dir, centers, radii, smooth_k,
                      mask: Optional[torch.Tensor] = None, num_steps: int = 40,
                      normal_eps: float = 1e-4,
                      t_init: Optional[torch.Tensor] = None,
                      early_exit: bool = False):
    """Plain PyTorch version → (t [N,1], normal [N,3]), both detached."""
    march_fn = march_early_exit if early_exit else march
    t = march_fn(ray_org, ray_dir, centers, radii, smooth_k, mask=mask,
                 num_steps=num_steps, t_init=t_init)
    dist_last = scene_sdf(ray_org + ray_dir * t, centers, radii, smooth_k,
                          mask=mask)
    p_final = ray_org + ray_dir * (t + dist_last)
    normal = scene_normal(p_final, centers, radii, smooth_k, mask=mask,
                          eps=normal_eps)
    return t, normal


def march_table(centers: torch.Tensor, radii: torch.Tensor,
                mask: Optional[torch.Tensor], smooth_k) -> torch.Tensor:
    """Plain version of the table pack → [M, 5] rows (cx, cy, cz, |c|², r·k),
    |c|² = (x² + y²) + z² with 1e30 in masked slots. The march kernel stages
    it as float4 (−2cx, −2cy, −2cz, |c|²) + r·k."""
    m = centers.shape[0]
    c = centers.detach().reshape(m, 3).float()
    x, y, z = c.unbind(dim=1)
    c_sq = (x * x + y * y) + z * z
    if mask is not None:
        c_sq = torch.where(mask.reshape(m).bool(), c_sq, 1e30)
    rk = radii.detach().reshape(m).float() * smooth_k
    return torch.cat([c, c_sq[:, None], rk[:, None]], dim=1)


@build.counted
@torch.no_grad()
def pack_march_table(centers: torch.Tensor, radii: torch.Tensor,
                     mask: Optional[torch.Tensor], smooth_k) -> torch.Tensor:
    """``march_table`` in one kernel launch for CUDA tensors (bitwise the
    plain version), the plain version for CPU tensors."""
    if centers.device.type == "cpu":
        return march_table(centers, radii, mask, smooth_k)
    dev = centers.device
    m = centers.shape[0]
    c = centers.detach()
    r = radii.detach().reshape(m)
    build.check_cuda_f32("centers", c, (m, 3), dev)
    build.check_cuda_f32("radii", r, (m,), dev)
    mask_u8 = None
    if mask is not None:
        mask_u8 = mask.reshape(m).bool().view(torch.uint8)
        if mask_u8.device != dev or not mask_u8.is_contiguous():
            raise ValueError("mask must be a contiguous tensor on the "
                             "centers' device")
    k = build.device_scalar(smooth_k, dev)
    out = torch.empty((m, 5), dtype=torch.float32, device=dev)
    _, launch_pack = _launchers()
    err = launch_pack(build.ptr(c), build.ptr(r), build.ptr(mask_u8), m,
                      build.ptr(k), build.ptr(out), build.stream_ptr(dev))
    build.check(err, "march_pack kernel launch")
    pack_march_table.launches += 1
    return out


@build.counted
@torch.no_grad()
def march_shade(ray_org: torch.Tensor, ray_dir: torch.Tensor,
                centers: torch.Tensor, radii: torch.Tensor, smooth_k,
                mask: Optional[torch.Tensor] = None, num_steps: int = 40,
                normal_eps: float = 1e-4,
                t_init: Optional[torch.Tensor] = None,
                early_exit: bool = False):
    """Fused detached march + normals → (t [N,1], normal [N,3]).

    ``t_init`` [N,1] warm-starts the march; pair it with a reduced
    ``num_steps``. ``smooth_k`` is a Python float or a one-element float32
    tensor on the rays' device, which the kernels read when they run (the
    training step's, recorded once in a CUDA graph and replayed).
    ``early_exit``: see the module docstring.
    """
    if ray_org.device.type == "cpu":
        return march_shade_plain(ray_org, ray_dir, centers, radii, smooth_k,
                                 mask=mask, num_steps=num_steps,
                                 normal_eps=normal_eps, t_init=t_init,
                                 early_exit=early_exit)
    if ray_org.device.type != "cuda":
        raise ValueError(f"march_shade: unsupported device {ray_org.device}")
    dev = ray_org.device
    n = ray_org.shape[0]
    m = centers.shape[0]
    build.check_cuda_f32("ray_org", ray_org, (n, 3), dev)
    build.check_cuda_f32("ray_dir", ray_dir, (n, 3), dev)
    if m < 1:
        raise ValueError("march_shade needs at least one primitive")
    if n == 0:
        return (torch.empty((0, 1), dtype=torch.float32, device=dev),
                torch.empty((0, 3), dtype=torch.float32, device=dev))
    k = build.device_scalar(smooth_k, dev)
    prim = pack_march_table(centers, radii, mask, k)
    t0 = None
    if t_init is not None:
        t0 = t_init.detach()
        build.check_cuda_f32("t_init", t0, (n, 1), dev)
    t = torch.empty((n, 1), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    launch_march, _ = _launchers()
    err = launch_march(build.ptr(ray_org), build.ptr(ray_dir), build.ptr(t0),
                       build.ptr(prim), n, m, build.ptr(k), int(num_steps),
                       float(normal_eps), int(bool(early_exit)),
                       build.ptr(t), build.ptr(normal),
                       build.stream_ptr(dev))
    build.check(err, "march_shade kernel launch")
    march_shade.launches += 1
    return t, normal

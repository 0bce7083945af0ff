"""K7: flat per-tile primitive selection in one launch (csrc/tile_select.cu;
no TPU kernel: the JAX package leaves selection to XLA).

``tile_select`` computes what ``ops/culling.tile_cones`` +
``select_tile_primitives`` + the table gathers compute (``tile_select_plain``):
each tile's bounding cone, the flat top-K selection against it and the
per-tile tables → (idx [B, K] int64, valid [B, K], cs [B, K, 3], rs [B, K],
qs [B, K] with 1e30 in invalid slots), K = min(k_budget, M). For CUDA tensors
it launches the kernel, for CPU tensors it runs the plain version. There is
no fallback: a CUDA tensor goes through the kernel or raises.

The kernel's scores repeat the plain version's operations, each rounded as
PyTorch rounds it; its cone's means are summed in another order than
PyTorch's reductions, so on the same rays the two cones, and through them
the scores, may differ by float32 rounding, and two rows whose scores lie
that close may trade places (or a row at the cutoff be kept by one only).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.ops.culling import (
    select_tile_primitives,
    selected_tables,
    tile_cones,
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# The largest table the kernel builds (TS_MAX_K in csrc/tile_select.cu).
MAX_K = 16384


@functools.cache
def _launcher():
    lib = build.load_library("tile_select")
    return build.bind(lib, "tile_select_launch",
                      [_P, _P, _I, _I, _P, _P, _P, _I, _P, _I] + [_P] * 7)


@torch.no_grad()
def tile_select_plain(ray_org: torch.Tensor, ray_dir: torch.Tensor,
                      tile: int, centers: torch.Tensor, radii: torch.Tensor,
                      smooth_k, k_budget: int,
                      mask: Optional[torch.Tensor] = None):
    """Plain version: tile_cones, select_tile_primitives and the gathers."""
    cones = tile_cones(ray_org, ray_dir, tile)
    idx, valid = select_tile_primitives(cones, centers, radii, smooth_k,
                                        k_budget, mask=mask)
    return (idx, valid) + selected_tables(centers, radii, idx, valid)


def tile_select(ray_org: torch.Tensor, ray_dir: torch.Tensor, tile: int,
                centers: torch.Tensor, radii: torch.Tensor, smooth_k,
                k_budget: int, mask: Optional[torch.Tensor] = None):
    """Per-tile top-K tables of consecutive ``tile``-ray tiles → (idx, valid,
    cs, rs, qs). ``smooth_k``: a Python float or a one-element float32
    tensor on the rays' device, which the kernel reads when it runs."""
    if ray_org.device.type == "cpu":
        return tile_select_plain(ray_org, ray_dir, tile, centers, radii,
                                 smooth_k, k_budget, mask)
    return launch_tile_select(ray_org, ray_dir, tile, centers, radii,
                              smooth_k, k_budget, mask)


@build.counted
@torch.no_grad()
def launch_tile_select(ray_org: torch.Tensor, ray_dir: torch.Tensor,
                       tile: int, centers: torch.Tensor, radii: torch.Tensor,
                       smooth_k, k_budget: int,
                       mask: Optional[torch.Tensor] = None,
                       with_cones: bool = False):
    """One K7 launch → (idx, valid, cs, rs, qs) and, ``with_cones``, the
    cones [B, 8] it selected against: each tile's apex, axis, cos_half and
    origin_spread as the kernel computed them, for checks against
    tile_cones."""
    dev = ray_org.device
    if dev.type != "cuda":
        raise ValueError(f"tile_select: unsupported device {dev}")
    n, m = ray_org.shape[0], centers.shape[0]
    if n % tile:
        raise ValueError(f"{n} rays do not split into tiles of {tile}")
    b, kk = n // tile, min(int(k_budget), m)
    if kk > MAX_K:
        raise ValueError(f"tile_select builds tables of at most {MAX_K} "
                         f"slots, got {kk}")
    ro, rd = ray_org.detach().contiguous(), ray_dir.detach().contiguous()
    c = centers.detach().contiguous()
    r = radii.detach().reshape(-1).contiguous()
    build.check_cuda_f32("ray_org", ro, (n, 3), dev)
    build.check_cuda_f32("ray_dir", rd, (n, 3), dev)
    build.check_cuda_f32("centers", c, (m, 3), dev)
    build.check_cuda_f32("radii", r, (m,), dev)
    live = None
    if mask is not None:
        live = mask.detach().reshape(-1)
        if live.dtype != torch.bool:
            live = live.bool()
        live = live.contiguous()
        if live.shape != (m,) or live.device != dev:
            raise ValueError(f"mask has shape {tuple(live.shape)} on "
                             f"{live.device}, expected ({m},) on {dev}")
    k = build.device_scalar(smooth_k, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    idx = torch.empty((b, kk), dtype=torch.int64, device=dev)
    valid = torch.empty((b, kk), dtype=torch.bool, device=dev)
    cs = torch.empty((b, kk, 3), **f32)
    rs = torch.empty((b, kk), **f32)
    qs = torch.empty((b, kk), **f32)
    cones = torch.empty((b, 8), **f32) if with_cones else None
    out = (idx, valid, cs, rs, qs) + ((cones,) if with_cones else ())
    if b == 0 or kk == 0:
        return out
    err = _launcher()(build.ptr(ro), build.ptr(rd), b, int(tile),
                      build.ptr(c), build.ptr(r), build.ptr(live), m,
                      build.ptr(k), kk, build.ptr(idx), build.ptr(valid),
                      build.ptr(cs), build.ptr(rs), build.ptr(qs),
                      build.ptr(cones), build.stream_ptr(dev))
    build.check(err, "tile_select kernel launch")
    launch_tile_select.launches += 1
    return out

"""K5: the march micro-variant kernel (port of
scripts/exp_march_variants.py::variant_march).

``variant_march`` launches the CUDA kernel of csrc/march_variants.cu for CUDA
tensors and runs ``variant_march_plain`` for CPU tensors. There is no
fallback: a CUDA tensor either goes through the kernel or raises. The plain
version mirrors the TPU kernel op for op (the two-pass row max and sum,
``torch.exp`` / ``torch.exp2``, ``torch.log`` / ``torch.log2``). The CUDA
kernel is K1's march (csrc/common.cuh's dense_march: the one-pass soft-min
with the SFU's approximate sqrt and exp), so its ``base`` equals K1 bitwise
on the same table and agrees with the plain version within the float32
noise of the march, not bitwise.

The three switches (``clamp``, ``exp2``, ``coord``) are template flags of the
march core; csrc/march_variants.cu's header says what each computes. The TPU
kernel's grid is ``n // tile_n`` and drops a remainder of rays; here a
``tile_n`` that does not divide the ray count raises, and otherwise it
changes nothing: the launch covers all rays with K1's blocks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from burn_raymarching_tpu_torch.ops.cuda import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

T_MAX = 1e4
NORMAL_EPS = 1e-4
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@functools.cache
def _launcher():
    return build.bind(build.load_library("march_variants"),
                      "march_variants_launch",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
                       _P, _P, _P])


def check_tile(n: int, tile_n: int) -> None:
    """Raise unless ``tile_n`` rays a block divide the ``n`` rays."""
    if tile_n < 1 or n % tile_n:
        raise ValueError(f"tile_n = {tile_n} does not divide the {n} rays "
                         f"(the TPU kernel's grid n // tile_n would drop "
                         f"{n % tile_n if tile_n > 0 else n} of them)")


def _soft_min_rows(p, centers, kr, c_sq, k, *, clamp: bool, exp2: bool,
                   coord: bool):
    """Soft-min of points p [N, 3] against the [3, M] centers → [N, 1]."""
    if coord:
        dx = p[:, 0:1] - centers[0:1, :]
        dy = p[:, 1:2] - centers[1:2, :]
        dz = p[:, 2:3] - centers[2:3, :]
        q = torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-6)
    else:
        p_sq = torch.sum(p * p, dim=1, keepdim=True)
        p_dot_c = p @ centers
        q = torch.clamp(p_sq + c_sq - 2.0 * p_dot_c, min=1e-6)
    val = torch.sqrt(q) * (-k) + kr
    if clamp:
        val = torch.clamp(val, max=80.0)
        if exp2:
            s = torch.sum(torch.exp2(val * LOG2E), dim=1, keepdim=True)
            return torch.log2(torch.clamp(s, min=1e-8)) * LN2 / (-k)
        s = torch.sum(torch.exp(val), dim=1, keepdim=True)
        return torch.log(torch.clamp(s, min=1e-8)) / (-k)
    mx = torch.amax(val, dim=1, keepdim=True)
    if exp2:
        s = torch.sum(torch.exp2((val - mx) * LOG2E), dim=1, keepdim=True)
        return (torch.log2(torch.clamp(s, min=1e-8)) * LN2 + mx) / (-k)
    s = torch.sum(torch.exp(val - mx), dim=1, keepdim=True)
    return (torch.log(torch.clamp(s, min=1e-8)) + mx) / (-k)


@torch.no_grad()
def variant_march_plain(ro, rd, t0, prim, c_sq, k, num_steps: int,
                        tile_n: int, clamp: bool, exp2: bool, coord: bool):
    """Plain PyTorch version → (t [N, 1], normal [N, 3]), in the inputs'
    dtype (float64 gives the yardstick of the float32 march)."""
    check_tile(ro.shape[0], tile_n)
    centers = prim[0:3, :]
    radius = prim[3:4, :]
    k = torch.as_tensor(k, dtype=ro.dtype, device=ro.device).reshape(())
    kr = radius * k
    sdf = functools.partial(_soft_min_rows, centers=centers, kr=kr,
                            c_sq=c_sq, k=k, clamp=clamp, exp2=exp2,
                            coord=coord)
    t = t0
    for _ in range(num_steps):
        t = torch.clamp(t + sdf(ro + rd * t), max=T_MAX)
    dist_last = sdf(ro + rd * t)
    p_final = ro + rd * (t + dist_last)

    def tap(axis: int, sign: float):
        cols = [p_final[:, i:i + 1] for i in range(3)]
        cols[axis] = cols[axis] + sign * NORMAL_EPS
        return sdf(torch.cat(cols, dim=1))

    normal = torch.cat([tap(a, 1.0) - tap(a, -1.0) for a in range(3)], dim=1)
    length = torch.sqrt(torch.sum(normal * normal, dim=1, keepdim=True)
                        + 1e-6)
    return t, normal / length


@build.counted
@torch.no_grad()
def variant_march(ro: torch.Tensor, rd: torch.Tensor, t0: torch.Tensor,
                  prim: torch.Tensor, c_sq: torch.Tensor, k, num_steps: int,
                  tile_n: int, clamp: bool, exp2: bool, coord: bool):
    """March + normals of one variant → (t [N, 1], normal [N, 3]).

    ro, rd [N, 3]; t0 [N, 1]; prim [4, M] rows (cx, cy, cz, r); c_sq [1, M]
    (1e30 in masked slots; ``coord`` reads the centers instead, so masked
    slots there need far centers); k a [1, 1] float32 tensor on the rays'
    device or a Python float. ``tile_n``: the TPU kernel's rays a grid
    step; it must divide N, and the CUDA launch does not depend on it.
    """
    n = ro.shape[0]
    check_tile(n, tile_n)
    if ro.device.type == "cpu":
        return variant_march_plain(ro, rd, t0, prim, c_sq, k, num_steps,
                                   tile_n, clamp, exp2, coord)
    if ro.device.type != "cuda":
        raise ValueError(f"variant_march: unsupported device {ro.device}")
    dev = ro.device
    m = prim.shape[1]
    build.check_cuda_f32("ro", ro, (n, 3), dev)
    build.check_cuda_f32("rd", rd, (n, 3), dev)
    build.check_cuda_f32("t0", t0, (n, 1), dev)
    build.check_cuda_f32("prim", prim, (4, m), dev)
    build.check_cuda_f32("c_sq", c_sq, (1, m), dev)
    if m < 1:
        raise ValueError("variant_march needs at least one slot")
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    k_dev = build.device_scalar(k, dev)
    t = torch.empty((n, 1), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    err = _launcher()(build.ptr(ro), build.ptr(rd), build.ptr(t0),
                      build.ptr(prim), build.ptr(c_sq), build.ptr(k_dev), n,
                      m, int(num_steps), NORMAL_EPS,
                      int(bool(clamp)), int(bool(exp2)), int(bool(coord)),
                      build.ptr(t), build.ptr(normal), build.stream_ptr(dev))
    build.check(err, "march_variants kernel launch")
    variant_march.launches += 1
    return t, normal

"""K2: fused shade/composite with a hand-derived backward (port of
burn_raymarching_tpu/ops/pallas/shade_kernel.py::shade_fused).

``shade_fused`` runs ``ShadeFused`` for CUDA tensors: three kernels of
csrc/shade.cu, one that packs the table from the parameter tensors
(``pack_shade_table``), the forward, and one backward launch that also sums
its per-block partial rows in a fixed order and writes the five gradients.
For CPU tensors it runs ``shade_plain`` (the render_diff tail under
autograd). t and normal come from the detached march and get no gradient.
The compositor constants 10 and 15 and the sigmoid coverage are hard-coded,
as in the TPU kernel; step_body routes other render configs to the plain
path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from burn_raymarching_tpu_torch.ops.cuda import build

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = build.load_library("shade")
    return {
        "pack": build.bind(lib, "shade_pack_launch", [_P] * 6 + [_I, _P, _P]),
        "fwd": build.bind(lib, "shade_fwd_launch",
                          [_P] * 5 + [_I, _I, _P, _I, _P, _P]),
        "bwd": build.bind(lib, "shade_bwd_launch",
                          [_P] * 6 + [_I, _I, _P, _I, _I] + [_P] * 5),
        "blocks": build.bind(lib, "shade_bwd_blocks", [_I, _I, _I]),
        "max_m": build.bind(lib, "shade_bwd_max_m", []),
    }


def shade_plain(ro, rd, t, normal, centers, radii, colors, light, ambient,
                smooth_k, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: render_diff's tail with (t, normal) injected."""
    from burn_raymarching_tpu_torch.render.diff import render_diff

    t_det, n_det = t.detach(), normal.detach()
    return render_diff(ro, rd, centers, colors, radii, light, ambient,
                       smooth_k, mask=mask,
                       march_normal_fn=lambda *a, **kw: (t_det, n_det))


def shade_table(centers, radii, colors, mask, light, ambient
                ) -> torch.Tensor:
    """Plain version of the table pack → [2M+2, 4], all detached (the
    kernel's d_centers already holds the |c|² chain): rows (cx, cy, cz,
    |c|²) with |c|² = (x² + y²) + z² and 1e30 in masked slots, then rows (r,
    colR, colG, colB), then (l̂x, l̂y, l̂z, ambient) and (|l|, n, 0, 0), n the
    number of leading columns that hold every live slot (M when none is
    live)."""
    m = centers.shape[0]
    c = centers.detach().reshape(m, 3).float()
    x, y, z = c.unbind(dim=1)
    c_sq = (x * x + y * y) + z * z
    n_live = torch.full((), float(m), device=c.device)
    if mask is not None:
        live = mask.reshape(m).bool()
        c_sq = torch.where(live, c_sq, 1e30)
        last = torch.amax(torch.where(
            live, torch.arange(1, m + 1, device=c.device), 0)).float()
        n_live = torch.where(last > 0, last, n_live)
    lt = light.detach().reshape(3).float()
    l_norm = torch.sqrt((lt[0] * lt[0] + lt[1] * lt[1]) + lt[2] * lt[2])
    zero = torch.zeros((), device=c.device)
    return torch.cat([
        torch.cat([c, c_sq[:, None]], dim=1),
        torch.cat([radii.detach().reshape(m, 1).float(),
                   colors.detach().reshape(m, 3).float()], dim=1),
        torch.cat([lt / l_norm, ambient.detach().reshape(1).float()])[None],
        torch.stack([l_norm, n_live, zero, zero])[None]], dim=0)


@build.counted
@torch.no_grad()
def pack_shade_table(centers, radii, colors, mask, light, ambient
                     ) -> torch.Tensor:
    """``shade_table`` in one kernel launch for CUDA tensors (bitwise the
    plain version), the plain version for CPU tensors."""
    if centers.device.type == "cpu":
        return shade_table(centers, radii, colors, mask, light, ambient)
    dev = centers.device
    m = centers.shape[0]
    args = [("centers", centers.detach(), (m, 3)),
            ("radii", radii.detach().reshape(m), (m,)),
            ("colors", colors.detach(), (m, 3)),
            ("light", light.detach(), (3,)),
            ("ambient", ambient.detach().reshape(1), (1,))]
    for name, x, shape in args:
        build.check_cuda_f32(name, x, shape, dev)
    mask_u8 = None
    if mask is not None:
        mask_u8 = mask.reshape(m).bool().view(torch.uint8)
        if mask_u8.device != dev or not mask_u8.is_contiguous():
            raise ValueError("mask must be a contiguous tensor on the "
                             "centers' device")
    c, r, col, lt, amb = (x for _, x, _ in args)
    out = torch.empty((2 * m + 2, 4), dtype=torch.float32, device=dev)
    err = _lib()["pack"](build.ptr(c), build.ptr(r), build.ptr(col),
                         build.ptr(mask_u8), build.ptr(lt), build.ptr(amb),
                         m, build.ptr(out), build.stream_ptr(dev))
    build.check(err, "shade_pack kernel launch")
    pack_shade_table.launches += 1
    return out


@build.counted
def launch_shade_fwd(ro, rd, t, normal, table, smooth_k,
                     lanes: int = 0) -> torch.Tensor:
    """Forward kernel → [N, 3]. ``table`` from ``pack_shade_table``;
    ``smooth_k`` a Python float or a one-element float32 tensor on the
    rays' device (read when the kernel runs); ``lanes`` per ray (a power of
    two up to 32), 0 for the kernel's rule."""
    n, m = ro.shape[0], table.shape[0] // 2 - 1
    out = torch.empty((n, 3), dtype=torch.float32, device=ro.device)
    err = _lib()["fwd"](build.ptr(ro), build.ptr(rd), build.ptr(t),
                        build.ptr(normal), build.ptr(table), n, m,
                        build.ptr(build.device_scalar(smooth_k, ro.device)),
                        lanes, build.ptr(out),
                        build.stream_ptr(ro.device))
    build.check(err, "shade forward kernel launch")
    launch_shade_fwd.launches += 1
    return out


@build.counted
def launch_shade_bwd(ro, rd, t, normal, table, smooth_k, g,
                     lanes: int = 0, reduce: bool = True):
    """One backward launch → (d_centers [M,3], d_radii [M], d_colors [M,3],
    d_light [3], d_ambient [1], partial [blocks, 7M+4]). ``partial`` holds
    the per-block rows (dcx, dcy, dcz, dr, dcolR, dcolG, dcolB, M each, then
    d_l̂ and d_ambient) that the launch itself sums in a fixed order; the
    gradients are views of that sum (d_centers and d_colors transposed).
    Without ``reduce`` it stops after the rows and the gradients are not
    set."""
    n, m = ro.shape[0], table.shape[0] // 2 - 1
    blocks, nodes = _bwd_plan(n, m, lanes)
    row_len = 7 * m + 4
    pitch = -(-row_len // 4) * 4
    # One allocation: the sum and d_light, then the partial rows, then the
    # sum tree's rows.
    buf = torch.empty(((1 + blocks + nodes) * pitch + 4,),
                      dtype=torch.float32, device=ro.device)
    total, rows = buf[:pitch + 4], buf[pitch + 4:].view(blocks + nodes, pitch)
    err = _lib()["bwd"](build.ptr(ro), build.ptr(rd), build.ptr(t),
                        build.ptr(normal), build.ptr(table), build.ptr(g), n,
                        m, build.ptr(build.device_scalar(smooth_k,
                                                         ro.device)),
                        lanes, int(reduce),
                        build.ptr(rows), build.ptr(rows[blocks:]),
                        build.ptr(build.tickets(ro.device, nodes)),
                        build.ptr(total), build.stream_ptr(ro.device))
    build.check(err, "shade backward kernel launch")
    launch_shade_bwd.launches += 1
    dprim = total[:7 * m].view(7, m)
    return (dprim[0:3].T, dprim[3], dprim[4:7].T, total[pitch:pitch + 3],
            total[7 * m + 3:row_len], rows[:blocks, :row_len])


@functools.cache
def _bwd_plan(n: int, m: int, lanes: int) -> tuple[int, int]:
    """(blocks, i.e. partial rows; nodes of the sum tree over them) of the
    backward launch for N rays and M slots."""
    lib = _lib()
    if m > lib["max_m"]():
        raise ValueError(f"shade backward kernel supports M <= "
                         f"{lib['max_m']()} (shared-memory accumulators); "
                         f"got {m}")
    blocks = lib["blocks"](n, m, lanes)
    if blocks < 1:
        raise ValueError(f"shade backward kernel: no launch plan for "
                         f"N = {n}, M = {m}, lanes = {lanes}")
    return blocks, build.tree_nodes(blocks)


class ShadeFused(torch.autograd.Function):
    """Pack + fused shade forward; the backward is one launch.

    Gradients flow to centers [M,3], radii [M,1], colors [M,3], light [3]
    and ambient [1]; none to ro, rd, t or normal.
    """

    @staticmethod
    def forward(ctx, ro, rd, t, normal, centers, radii, colors, light,
                ambient, smooth_k, mask):
        dev = ro.device
        n = ro.shape[0]
        for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)),
                               ("t", t, (n, 1)), ("normal", normal, (n, 3))):
            build.check_cuda_f32(name, x, shape, dev)
        table = pack_shade_table(centers, radii, colors, mask, light, ambient)
        k = build.device_scalar(smooth_k, dev)
        out = launch_shade_fwd(ro, rd, t, normal, table, k)
        # The backward reads k from the same memory, as the TPU kernel's
        # saved table holds its traced scalar.
        ctx.save_for_backward(ro, rd, t, normal, table, k)
        ctx.shapes = (radii.shape, ambient.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        ro, rd, t, normal, table, k = ctx.saved_tensors
        d_centers, d_radii, d_colors, d_light, d_ambient, _ = launch_shade_bwd(
            ro, rd, t, normal, table, k, g.contiguous().float())
        radii_shape, amb_shape = ctx.shapes
        return (None, None, None, None, d_centers,
                d_radii.reshape(radii_shape), d_colors, d_light,
                d_ambient.reshape(amb_shape), None, None)


def shade_fused(ro: torch.Tensor, rd: torch.Tensor, t: torch.Tensor,
                normal: torch.Tensor, centers: torch.Tensor,
                radii: torch.Tensor, colors: torch.Tensor,
                light: torch.Tensor, ambient: torch.Tensor, smooth_k,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused shade/composite → [N, 3] with analytic parameter gradients.

    centers/radii/colors/light/ambient are the physical (activated)
    parameters; ``smooth_k`` is a Python float or a one-element float32
    tensor on the rays' device (the training step's), which the forward
    and backward kernels read when they run.
    """
    if ro.device.type == "cpu":
        return shade_plain(ro, rd, t, normal, centers, radii, colors, light,
                           ambient, smooth_k, mask=mask)
    if ro.device.type != "cuda":
        raise ValueError(f"shade_fused: unsupported device {ro.device}")
    return ShadeFused.apply(ro, rd, t.detach(), normal.detach(), centers,
                            radii, colors, light, ambient, smooth_k, mask)

"""K6: the culled training step's gradient-carrying tail, fused, with a
hand-derived backward (csrc/culled_shade.cu; no TPU kernel: the JAX package
leaves this tail to XLA).

``culled_shade`` computes what ``render/culled.render_diff_culled`` runs
when the training step hands it ``precomputed`` (the detached K3 march's t
and normal) at ``model_axis=None``: the reattaching soft-min, Lambertian
lighting from the detached normal, the softmax compositing, the soft-min at
the converged point and sigmoid coverage without a pixel footprint. For
CUDA tensors it runs ``CulledShadeFused``: one forward launch and one
backward launch over each tile's live table columns, with nothing of shape
[B, T, K] in device memory; for CPU tensors the plain version
(``culled_shade_plain``, render_diff_culled itself). There is no fallback:
a CUDA tensor goes through the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.render.culled import render_diff_culled

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib():
    lib = build.load_library("culled_shade")
    return {
        "fwd": build.bind(lib, "ctail_fwd_launch",
                          [_P] * 11 + [_I] * 3 + [_F] * 2 + [_P] * 3),
        "bwd": build.bind(lib, "ctail_bwd_launch",
                          [_P] * 13 + [_I] * 3 + [_F] * 2 + [_P] * 9),
        "groups": build.bind(lib, "ctail_groups", [_I]),
    }


def culled_shade_plain(ro, rd, t, normal, centers_t, colors_t, radii_t,
                       valid, light, ambient, smooth_k,
                       softmax_sharpness: float,
                       mask_sharpness: float) -> torch.Tensor:
    """Plain version → [B T, 3]: render_diff_culled's tail on the gathered
    tables (an identity gather of them), with (t, normal) precomputed."""
    b, k = valid.shape
    tile = ro.shape[1]
    idx = torch.arange(b * k, device=valid.device).reshape(b, k)
    return render_diff_culled(
        ro.reshape(-1, 3), rd.reshape(-1, 3), centers_t.reshape(-1, 3),
        colors_t.reshape(-1, 3), radii_t.reshape(-1, 1), light, ambient,
        smooth_k, tile=tile, k_budget=k,
        softmax_sharpness=softmax_sharpness, mask_sharpness=mask_sharpness,
        precomputed=(idx, valid, t.detach(), normal.detach()))


def _check(ro, rd, t, normal, centers_t, colors_t, radii_t, valid, light,
           ambient) -> None:
    dev = ro.device
    b, tile, k = ro.shape[0], ro.shape[1], valid.shape[1]
    for name, x, shape in (("ro", ro, (b, tile, 3)), ("rd", rd, (b, tile, 3)),
                           ("t", t, (b, tile, 1)),
                           ("normal", normal, (b, tile, 3)),
                           ("centers_t", centers_t, (b, k, 3)),
                           ("colors_t", colors_t, (b, k, 3)),
                           ("radii_t", radii_t, (b, k)),
                           ("light", light, (3,)),
                           ("ambient", ambient.reshape(-1), (1,))):
        build.check_cuda_f32(name, x, shape, dev)
    if (valid.device != dev or valid.dtype != torch.bool
            or tuple(valid.shape) != (b, k) or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool [{b}, {k}] tensor "
                         f"on {dev}")
    if b * tile * k == 0:
        raise ValueError("culled_shade needs at least one tile, ray and slot")


def _args(ro, rd, t, normal, centers_t, colors_t, radii_t, valid, light,
          ambient, k) -> list:
    return [build.ptr(x) for x in (ro, rd, t, normal, centers_t, colors_t,
                                   radii_t, valid.view(torch.uint8), light,
                                   ambient, k)]


@build.counted
def launch_ctail_fwd(ro, rd, t, normal, centers_t, colors_t, radii_t, valid,
                     light, ambient, k, softmax_sharpness: float,
                     mask_sharpness: float):
    """Forward launch → (out [B T, 3], state [B T, 8]: per ray the soft-min's
    minimum and sum at p0 and at p, the softmax's sum and mix). ``k`` is the
    [1] float32 device scalar."""
    b, tile, ks = ro.shape[0], ro.shape[1], valid.shape[1]
    out = torch.empty((b * tile, 3), dtype=torch.float32, device=ro.device)
    state = torch.empty((b * tile, 8), dtype=torch.float32, device=ro.device)
    err = _lib()["fwd"](*_args(ro, rd, t, normal, centers_t, colors_t,
                               radii_t, valid, light, ambient, k),
                        b, tile, ks, float(softmax_sharpness),
                        float(mask_sharpness), build.ptr(out),
                        build.ptr(state), build.stream_ptr(ro.device))
    build.check(err, "culled shade forward kernel launch")
    launch_ctail_fwd.launches += 1
    return out, state


@build.counted
def launch_ctail_bwd(ro, rd, t, normal, centers_t, colors_t, radii_t, valid,
                     light, ambient, k, state, g, softmax_sharpness: float,
                     mask_sharpness: float):
    """Backward launch → (d_centers_t [B,K,3], d_colors_t [B,K,3],
    d_radii_t [B,K], d_light [3], d_ambient [1]). The per-block rows of each
    tile, and of the light and ambient, are summed inside the launch in a
    fixed order."""
    dev = ro.device
    b, tile, ks = ro.shape[0], ro.shape[1], valid.shape[1]
    groups = _lib()["groups"](tile)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((b * groups * 7 * ks,), **f32)
    lpart = torch.empty((b * groups * 4,), **f32)
    d_centers = torch.empty((b, ks, 3), **f32)
    d_colors = torch.empty((b, ks, 3), **f32)
    d_radii = torch.empty((b, ks), **f32)
    d_light = torch.empty((3,), **f32)
    d_ambient = torch.empty((1,), **f32)
    err = _lib()["bwd"](*_args(ro, rd, t, normal, centers_t, colors_t,
                               radii_t, valid, light, ambient, k),
                        build.ptr(state), build.ptr(g), b, tile, ks,
                        float(softmax_sharpness), float(mask_sharpness),
                        build.ptr(part), build.ptr(lpart),
                        build.ptr(build.tickets(dev, b + 1)),
                        build.ptr(d_centers), build.ptr(d_radii),
                        build.ptr(d_colors), build.ptr(d_light),
                        build.ptr(d_ambient), build.stream_ptr(dev))
    build.check(err, "culled shade backward kernel launch")
    launch_ctail_bwd.launches += 1
    return d_centers, d_colors, d_radii, d_light, d_ambient


class CulledShadeFused(torch.autograd.Function):
    """The K6 forward; the backward is one launch. Gradients flow to
    centers_t (the |c|² chain included), colors_t, radii_t, light and
    ambient; none to the rays, t, normal or valid."""

    @staticmethod
    def forward(ctx, ro, rd, t, normal, centers_t, colors_t, radii_t, valid,
                light, ambient, smooth_k, softmax_sharpness, mask_sharpness):
        _check(ro, rd, t, normal, centers_t, colors_t, radii_t, valid, light,
               ambient)
        k = build.device_scalar(smooth_k, ro.device)
        amb = ambient.reshape(1)
        out, state = launch_ctail_fwd(ro, rd, t, normal, centers_t, colors_t,
                                      radii_t, valid, light, amb, k,
                                      softmax_sharpness, mask_sharpness)
        ctx.save_for_backward(ro, rd, t, normal, centers_t, colors_t, radii_t,
                              valid, light, amb, k, state)
        ctx.consts = (softmax_sharpness, mask_sharpness, ambient.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        softmax_sharpness, mask_sharpness, amb_shape = ctx.consts
        d_c, d_col, d_r, d_l, d_amb = launch_ctail_bwd(
            *ctx.saved_tensors, g.contiguous().float(), softmax_sharpness,
            mask_sharpness)
        return (None, None, None, None, d_c, d_col, d_r, None, d_l,
                d_amb.reshape(amb_shape), None, None, None)


def culled_shade(ro: torch.Tensor, rd: torch.Tensor, t: torch.Tensor,
                 normal: torch.Tensor, centers_t: torch.Tensor,
                 colors_t: torch.Tensor, radii_t: torch.Tensor,
                 valid: torch.Tensor, light: torch.Tensor,
                 ambient: torch.Tensor, smooth_k, softmax_sharpness: float,
                 mask_sharpness: float) -> torch.Tensor:
    """The culled tail → [B T, 3] with analytic gradients.

    ro, rd, normal [B, T, 3] and t [B, T, 1] are the tile batch and the
    detached march's result; centers_t, colors_t [B, K, 3], radii_t [B, K]
    the tables gathered from the physical parameters
    (ops/culling.gather_tile_tables), valid [B, K] their mask; light [3],
    ambient [1] physical. ``smooth_k`` is a Python float or a one-element
    float32 tensor on the rays' device, read when the kernels run.
    """
    if ro.device.type == "cpu":
        return culled_shade_plain(ro, rd, t, normal, centers_t, colors_t,
                                  radii_t, valid, light, ambient, smooth_k,
                                  softmax_sharpness, mask_sharpness)
    if ro.device.type != "cuda":
        raise ValueError(f"culled_shade: unsupported device {ro.device}")
    return CulledShadeFused.apply(
        ro.contiguous(), rd.contiguous(), t.detach().contiguous(),
        normal.detach().contiguous(), centers_t.contiguous(),
        colors_t.contiguous(), radii_t.contiguous(), valid.contiguous(),
        light, ambient, smooth_k, float(softmax_sharpness),
        float(mask_sharpness))

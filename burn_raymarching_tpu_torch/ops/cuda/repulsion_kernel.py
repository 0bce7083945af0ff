"""K4: two-level cluster repulsion, forward and recompute backward (port of
burn_raymarching_tpu/ops/pallas/repulsion_kernel.py::cluster_repulsion_fused).

``cluster_repulsion_fused`` keeps the differentiable prep (member gather,
centroid means, neighbor top-k or the frozen static tables, far weights) in
torch autograd, exactly as the JAX package keeps it outside its custom VJP,
and hands the coordinate planes to ``repulsion_sum``. For CUDA tensors that
is ``RepulsionSum`` (csrc/repulsion.cu): one forward launch that returns the
scalar and one backward launch that returns d_members, d_neighbor_members
and d_centroids complete; the sums over blocks are taken inside the
launches in a fixed order. For CPU tensors it is ``repulsion_sum_plain``
under autograd. Shapes are exact: the TPU kernel's 128-lane padding is not
carried over. Under ``far_field="monopole"`` the [C, C] centroid term stays
plain torch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from burn_raymarching_tpu_torch.ops.cuda import build
from burn_raymarching_tpu_torch.train.loss import (
    RepulsionStatic,
    _centroids,
    _member_weights,
    centroid_d2,
    near_tables,
)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = build.load_library("repulsion")
    return {
        "fwd": build.bind(lib, "rep_fwd_launch",
                          [_P] * 8 + [_I] * 7 + [_P] * 4),
        "bwd": build.bind(lib, "rep_bwd_launch",
                          [_P] * 9 + [_I] * 7 + [_P] * 8),
        "slices": build.bind(lib, "rep_slices", [_I] * 6),
    }


def _pair_denoms(d2: torch.Tensor, extra) -> torch.Tensor:
    return torch.sqrt(torch.clamp(d2, min=1e-6)) + extra + 1e-6


def repulsion_sum_plain(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                        include_far: bool) -> torch.Tensor:
    """Plain version of the kernel's sum: near field over [C, G, W·G] and,
    with ``include_far``, the member→centroid far field over [C, G, C_all].
    cs [3, C, G], nb_cs [3, C, W·G], cents [3, C_all] coordinate planes."""
    d2 = sum((cs[x][:, :, None] - nb_cs[x][:, None, :]) ** 2
             for x in range(3))
    self_pair = (mi[:, :, None] == nbm[:, None, :]).to(cs.dtype)
    s = torch.sum((w[:, :, None] * nb_w[:, None, :])
                  / _pair_denoms(d2, self_pair * 100.0))
    if include_far:
        d2f = sum((cs[x][:, :, None] - cents[x][None, None, :]) ** 2
                  for x in range(3))
        s = s + torch.sum((w[:, :, None] * far_w[:, None, :])
                          / _pair_denoms(d2f, 0.0))
    return s


def _slices(c, g, wg, ca, include_far: bool, slices: int) -> int:
    n = _lib()["slices"](c, g, wg, ca, int(include_far), slices)
    if n < 1:
        raise ValueError(f"repulsion kernel: no launch plan for C = {c}, "
                         f"G = {g}, W·G = {wg}, C_all = {ca}, "
                         f"slices = {slices}")
    return n


@build.counted
def launch_rep_fwd(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                   include_far: bool, slices: int = 0, reduce: bool = True):
    """One forward launch → (sum, 0-dim; per-block partial sums [C·S]).
    ``slices`` S per cluster, 0 for the kernel's rule. The launch itself
    adds the partials in index order; without ``reduce`` it stops after
    writing them and the sum is not set."""
    c, g = w.shape
    wg, ca = nb_w.shape[1], cents.shape[1]
    dev = cs.device
    n_slices = _slices(c, g, wg, ca, include_far, slices)
    out = torch.empty((1 + c * n_slices,), dtype=torch.float32, device=dev)
    total, partial = out[0], out[1:]
    err = _lib()["fwd"](*(build.ptr(x) for x in (cs, nb_cs, cents, w, nb_w,
                                                 mi, nbm, far_w)),
                        c, g, wg, ca, int(include_far), slices, int(reduce),
                        build.ptr(partial), build.ptr(build.tickets(dev, 1)),
                        build.ptr(total), build.stream_ptr(dev))
    build.check(err, "repulsion forward kernel launch")
    launch_rep_fwd.launches += 1
    return total, partial


@build.counted
def launch_rep_bwd(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w, g_out,
                   include_far: bool, slices: int = 0, reduce: bool = True):
    """One backward launch → (d_cs [3,C,G], d_nb_cs [3,C,W·G], d_cents
    [3,C_all], per-cluster d_centroid partials [C,3,C_all]); the last two
    are None without the far field. The launch adds a cluster's slices in
    slice order and the clusters' partials as a fixed tree; without
    ``reduce`` d_cents is not set."""
    c, g = w.shape
    wg, ca = nb_w.shape[1], cents.shape[1]
    dev = cs.device
    lib = _lib()
    n_slices = _slices(c, g, wg, ca, include_far, slices)
    nodes = build.tree_nodes(c)
    d_cs = torch.empty((3, c, g), dtype=torch.float32, device=dev)
    d_nb = torch.empty((3, c, wg), dtype=torch.float32, device=dev)
    cs_part = (torch.empty((n_slices, 3, c, g), dtype=torch.float32,
                           device=dev) if n_slices > 1 else None)
    d_cents = part = total = rows = None
    if include_far:
        pitch = -(-3 * ca // 4) * 4
        rows = torch.empty((1 + c + nodes, pitch), dtype=torch.float32,
                           device=dev)
        total = rows[0]
        d_cents = total[:3 * ca].unflatten(0, (3, ca))
        part = rows[1:1 + c, :3 * ca].unflatten(1, (3, ca))
    err = lib["bwd"](*(build.ptr(x) for x in (cs, nb_cs, cents, w, nb_w,
                                              mi, nbm, far_w, g_out)),
                     c, g, wg, ca, int(include_far), slices, int(reduce),
                     build.ptr(d_cs), build.ptr(cs_part), build.ptr(d_nb),
                     build.ptr(None if rows is None else rows[1:]),
                     build.ptr(None if rows is None else rows[1 + c:]),
                     build.ptr(total),
                     build.ptr(build.tickets(dev, c + nodes)),
                     build.stream_ptr(dev))
    build.check(err, "repulsion backward kernel launch")
    launch_rep_bwd.launches += 1
    return d_cs, d_nb, d_cents, part


class RepulsionSum(torch.autograd.Function):
    """Kernel forward; the backward recomputes every pair. Gradients flow
    to cs, nb_cs and cents only."""

    @staticmethod
    def forward(ctx, cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                include_far: bool):
        dev = cs.device
        c, g = w.shape
        wg, ca = nb_w.shape[1], cents.shape[1]
        for name, x, shape in (("cs", cs, (3, c, g)),
                               ("nb_cs", nb_cs, (3, c, wg)),
                               ("cents", cents, (3, ca)), ("w", w, (c, g)),
                               ("nb_w", nb_w, (c, wg)),
                               ("far_w", far_w, (c, ca))):
            build.check_cuda_f32(name, x, shape, dev)
        for name, x, shape in (("mi", mi, (c, g)), ("nbm", nbm, (c, wg))):
            if (x.device != dev or x.dtype != torch.int32
                    or tuple(x.shape) != shape or not x.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous int32 "
                                 f"{shape} tensor on {dev}")
        total, _ = launch_rep_fwd(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                                  include_far)
        ctx.save_for_backward(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w)
        ctx.include_far = include_far
        return total

    @staticmethod
    def backward(ctx, g_out):
        g = g_out.detach().reshape(1).float().contiguous()
        d_cs, d_nb, d_cents, _ = launch_rep_bwd(*ctx.saved_tensors, g,
                                                ctx.include_far)
        return d_cs, d_nb, d_cents, None, None, None, None, None, None


def repulsion_sum(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                  include_far: bool) -> torch.Tensor:
    """Near (+ member far) repulsion sum: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if cs.device.type == "cpu":
        return repulsion_sum_plain(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                                   include_far)
    if cs.device.type != "cuda":
        raise ValueError(f"repulsion_sum: unsupported device {cs.device}")
    return RepulsionSum.apply(cs, nb_cs, cents, w, nb_w, mi, nbm, far_w,
                              include_far)


def repulsion_planes(centers: torch.Tensor, clusters,
                     mask: Optional[torch.Tensor], near_clusters: int = 8,
                     static: Optional[RepulsionStatic] = None):
    """The differentiable prep, as in the JAX package's fused wrapper →
    (planes for ``repulsion_sum``, centroids [C,3], counts [C], far
    weights [C,C], centroid d2 [C,C] or None on the static path)."""
    member_idx = clusters.member_idx
    c_count, g = member_idx.shape
    cs = centers[member_idx.reshape(-1)].reshape(c_count, g, 3)
    if static is not None:
        w, counts = static.w, static.counts
        centroids = _centroids(cs, w, counts)
        nb, nbm, nb_w, far_w = (static.nb, static.nbm_idx, static.nb_w,
                                static.far_w)
        cd2 = None
    else:
        w = _member_weights(clusters, mask).to(centers.dtype)
        counts = torch.sum(w, dim=1)
        centroids = _centroids(cs, w, counts)
        cd2 = centroid_d2(centroids, counts)
        nb, nbm, nb_w, far_w = near_tables(member_idx, w, counts,
                                           cd2.detach(),
                                           min(near_clusters, c_count))
    nb_cs = cs[nb].reshape(c_count, -1, 3)
    planes = (cs.permute(2, 0, 1).contiguous(),
              nb_cs.permute(2, 0, 1).contiguous(),
              centroids.T.contiguous(), w.contiguous(), nb_w.contiguous(),
              member_idx.to(torch.int32).contiguous(),
              nbm.to(torch.int32).contiguous(), far_w.contiguous())
    return planes, centroids, counts, far_w, cd2


def cluster_repulsion_fused(centers: torch.Tensor, clusters,
                            mask: Optional[torch.Tensor], n_valid,
                            near_clusters: int = 8, far_field: str = "member",
                            static: Optional[RepulsionStatic] = None
                            ) -> torch.Tensor:
    """Drop-in for train/loss.cluster_repulsion (same decomposition,
    epsilons and +100 self-pair offset) with the pair sums in K4."""
    planes, centroids, counts, far_w, cd2 = repulsion_planes(
        centers, clusters, mask, near_clusters, static)
    include_far = far_field != "monopole"
    s = repulsion_sum(*planes, include_far)
    if not include_far:
        if cd2 is None:
            cd2 = centroid_d2(centroids, counts)
        inv_cc = 1.0 / (torch.sqrt(torch.clamp(cd2, min=1e-6)) + 1e-6)
        s = s + torch.sum(far_w * counts[:, None] * inv_cc)
    return s / (n_valid * n_valid)

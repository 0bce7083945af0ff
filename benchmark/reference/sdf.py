"""SDF primitives and the batched scene field (port of burn_raymarching_tpu/ops/sdf.py).

Everything is batched [N, M]; point-to-sphere distances use the expanded
form ||p||^2 + ||c||^2 - 2 p.c; padded primitive slots are excluded with a
validity mask (-1e30 logits) so shapes stay fixed while M changes across
density-control stages. ``smooth_min`` (dead in the reference) is not ported.

With ``model_axis`` (a parallel.collectives.Axis) the primitive arguments
are this rank's shard of an M-sharded table: the soft-min combines shards
with a two-pass logsumexp, the global max from the detached local maxima,
then the summed denominator.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .collectives import Axis, pmax, psum

# Finite stand-in for -inf in masked logits: exp(x - max) underflows to
# exactly 0 without inf-inf NaNs in forward or backward.
MASKED_NEG = -1e30


def sphere_sdf(p: torch.Tensor, center: torch.Tensor,
               radius: torch.Tensor) -> torch.Tensor:
    """Signed distance from points ``p`` [N,3] to one sphere → [N, 1].

    sqrt(sum(diff^2) + 1e-6) - radius.
    """
    diff = p - center[None, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=1, keepdim=True) + 1e-6)
    return d - torch.reshape(radius, (1, 1))


def soft_min(dists: torch.Tensor, k, mask: Optional[torch.Tensor] = None,
             model_axis: Optional[Axis] = None) -> torch.Tensor:
    """Stable LogSumExp soft-min over the primitive axis → [N, 1].

    -(log(clamp(sum(exp(-k d - max)), 1e-8)) + max) / k with the row max
    detached. ``mask``: optional [M] validity of padded slots. With
    ``model_axis`` the max is reduced (detached) and the exp sum summed over
    the shards; the result is replicated.
    """
    val = dists * (-k)
    if mask is not None:
        val = torch.where(mask[None, :].bool(), val,
                          torch.full_like(val, MASKED_NEG))
    max_val = torch.amax(val, dim=1, keepdim=True).detach()
    if model_axis is not None:
        max_val = pmax(max_val, model_axis)
    sum_exp = torch.sum(torch.exp(val - max_val), dim=1, keepdim=True)
    if model_axis is not None:
        sum_exp = psum(sum_exp, model_axis)
    return (torch.log(torch.clamp(sum_exp, min=1e-8)) + max_val) / (-k)


def pairwise_sphere_dists(p: torch.Tensor, centers: torch.Tensor,
                          radii: torch.Tensor) -> torch.Tensor:
    """[N, M] surface distances via the expanded form.

    ||p-c||^2 = ||p||^2 + ||c||^2 - 2 p.c, clamped at 1e-6 before the sqrt,
    minus the radius row. p: [N,3], centers: [M,3], radii: [M,1] or [M].
    """
    p_sq = torch.sum(p * p, dim=1, keepdim=True)              # [N, 1]
    c_sq = torch.sum(centers * centers, dim=1)[None, :]       # [1, M]
    p_dot_c = p @ centers.T                                   # [N, M], fp32
    dists_sq = p_sq + c_sq - 2.0 * p_dot_c
    dists = torch.sqrt(torch.clamp(dists_sq, min=1e-6))
    return dists - torch.reshape(radii, (1, -1))


def scene_sdf(p: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor,
              smooth_k, mask: Optional[torch.Tensor] = None,
              model_axis: Optional[Axis] = None) -> torch.Tensor:
    """Soft-min SDF of the whole scene at points ``p`` [N,3] → [N,1].
    ``centers``/``radii``/``mask`` may be one shard (``model_axis``); a
    ``p`` that carries a gradient must then be marked as the shard's input
    (collectives.pvary)."""
    return soft_min(pairwise_sphere_dists(p, centers, radii), smooth_k,
                    mask=mask, model_axis=model_axis)


# 6-tap central-difference offsets (+x, -x, +y, -y, +z, -z).
_NORMAL_TAPS = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))


@functools.cache
def _normal_taps(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """_NORMAL_TAPS [6, 3] on ``device``, copied there once (a copy from
    host memory cannot be recorded in a CUDA graph)."""
    return torch.tensor(_NORMAL_TAPS, dtype=dtype, device=device)


def scene_normal(p: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor,
                 smooth_k, mask: Optional[torch.Tensor] = None,
                 eps: float = 1e-4, model_axis: Optional[Axis] = None
                 ) -> torch.Tensor:
    """Central-difference surface normals, batched as one [6N, M] SDF eval.

    Finite differences normalized by sqrt(sum(n^2) + 1e-6). p: [N,3] → [N,3].
    """
    n = p.shape[0]
    offsets = _normal_taps(p.dtype, p.device) * eps
    p_taps = (p[:, None, :] + offsets[None, :, :]).reshape(n * 6, 3)
    d = scene_sdf(p_taps, centers, radii, smooth_k, mask=mask,
                  model_axis=model_axis).reshape(n, 6)
    normal = torch.stack(
        [d[:, 0] - d[:, 1], d[:, 2] - d[:, 3], d[:, 4] - d[:, 5]], dim=1)
    length = torch.sqrt(torch.sum(normal * normal, dim=1, keepdim=True) + 1e-6)
    return normal / length

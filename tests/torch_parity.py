"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port, so the two see identical arrays. Tests that need a GPU take
the ``cuda_device`` fixture, which decides at run time (never at import)
and skips without a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# Tier-1 runs several pytest workers; keep torch's intra-op pool small.
torch.set_num_threads(2)

DANGO_CENTERS = np.asarray([[-0.3, 0.0, 0.0], [0.0, 0.0, 0.0],
                            [0.3, 0.0, 0.0]], np.float32)
DANGO_COLORS = np.eye(3, dtype=np.float32)
DANGO_RADII = np.asarray([[0.2], [0.15], [0.2]], np.float32)


def tt(x, **kw) -> torch.Tensor:
    """numpy / JAX array → torch tensor (CPU)."""
    return torch.as_tensor(np.array(x), **kw)


def nn(x) -> np.ndarray:
    """torch tensor / JAX array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def random_raw_params(seed: int, m: int) -> dict:
    """Raw SceneParams arrays (numpy) with the checkpoint keys."""
    rng = np.random.default_rng(seed)
    return {
        "centers": rng.normal(0, 0.3, (m, 3)).astype(np.float32),
        "colors": rng.normal(0, 1.5, (m, 3)).astype(np.float32),
        "radii": rng.normal(-1.0, 0.5, (m, 1)).astype(np.float32),
        "light_dir": np.asarray([0.3, 1.0, -0.4], np.float32),
        "ambient": np.asarray([-1.0], np.float32),
    }


def jax_params(d: dict):
    import jax.numpy as jnp

    from burn_raymarching_tpu.models.scene import SceneParams

    return SceneParams(**{k: jnp.asarray(v) for k, v in d.items()})


def pad_raw(d: dict, pad: int) -> dict:
    """Append ``pad`` zero primitive rows."""
    out = dict(d)
    for k in ("centers", "colors", "radii"):
        out[k] = np.concatenate([d[k], np.zeros((pad, d[k].shape[1]),
                                                np.float32)])
    return out


def staged_q(p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., N, M] as the march kernels form them from a
    staged table ([M, 5], or [B, M, 5] with p [B, N, 3]; rows cx, cy, cz,
    |c|², r): the center scaled by −2, then
    (|p|² + |c|²) + (px·cx' + (py·cy' + pz·cz'))."""
    px, py, pz = (p[..., i, None] for i in range(3))
    cx, cy, cz = (-2.0 * table[..., None, :, i] for i in range(3))
    p_sq = (px * px + py * py) + pz * pz
    return (p_sq + table[..., None, :, 3]) + (px * cx + (py * cy + pz * cz))


def expanded_q(p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The same distances in the expanded form the kernels used before the
    −2 was folded into the table: (|p|² + |c|²) − 2 (px·cx + (py·cy +
    pz·cz))."""
    px, py, pz = (p[..., i, None] for i in range(3))
    cx, cy, cz = (table[..., None, :, i] for i in range(3))
    p_sq = (px * px + py * py) + pz * pz
    return (p_sq + table[..., None, :, 3]) - 2.0 * (px * cx
                                                    + (py * cy + pz * cz))


def soft_min_online(dists: torch.Tensor, k: float, lanes: int = 4,
                    skip_below: float = float("inf")) -> torch.Tensor:
    """The march kernels' one-pass soft-min of ``dists`` [N, M] → [N, 1], in
    plain PyTorch: ``lanes`` lanes stride over the columns, each keeping a
    running max m and a sum s relative to it (a column with d = v − m adds
    e = exp(−|d|) as s + e, or as s·e + 1 when it raises the max), then the
    lanes merge by the overall max. ``skip_below`` sets e = 0 where
    |d| >= it, which the kernels do not do: at 40 it must change no bit."""
    val = dists * (-k)
    n, m_cols = val.shape
    m = torch.full((n, lanes), -torch.inf, dtype=val.dtype)
    s = torch.zeros((n, lanes), dtype=val.dtype)
    for j in range(m_cols):
        lane, v = j % lanes, val[:, j]
        d = v - m[:, lane]
        e = torch.where(d.abs() < skip_below, torch.exp(-d.abs()),
                        torch.zeros_like(d))
        s[:, lane] = torch.where(d > 0, s[:, lane] * e + 1.0, s[:, lane] + e)
        m[:, lane] = torch.maximum(m[:, lane], v)
    mx = m.amax(dim=1, keepdim=True)
    total = torch.sum(s * torch.exp(m - mx), dim=1, keepdim=True)
    return (torch.log(torch.clamp(total, min=1e-8)) + mx) / (-k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)

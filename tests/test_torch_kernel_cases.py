"""The kernel tests' yardstick (burn_raymarching_tpu_torch/tools/
kernel_cases.py) on CPU tensors: each check passes what is right and fails
a planted fault.

The march check (``march_errors`` under K1's rule: the larger of the fixed
``MARCH_TOLS`` and ``march_noise_tols``, 5x the plain float32 march's own
gap to float64) on the plain march of config 1's inputs at 8 slots, held
against itself and against copies with t shifted on the rays that hit,
with the normals rotated, and with one hit ray sent past the scene; the
bound, whose larger term names it; the frame gaps of ``u8_gaps``.
"""

import math

import numpy as np
import pytest
import torch

from burn_raymarching_tpu_torch.ops.cuda import march_shade_kernel as k1
from burn_raymarching_tpu_torch.tools import kernel_cases as kc


@pytest.fixture(scope="module")
def march():
    """The plain march of config 1's 16,384 dango rays against 7 live
    primitives in 8 slots, in float32 and float64."""
    ro, rd, padded, mask, activate, _ = kc.main_path_inputs("cpu", 7, 8)
    with torch.no_grad():
        c, _, r, _, _ = activate(padded)
    t, n = k1.march_shade_plain(ro, rd, c, r, kc.K1_K, mask=mask)
    t_64, n_64 = k1.march_shade_plain(ro.double(), rd.double(), c.double(),
                                      r.double(), kc.K1_K, mask=mask)
    return t, n, t_64, n_64


def _rotated(n: torch.Tensor, angle: float) -> torch.Tensor:
    """Normals rotated by ``angle`` about the z axis."""
    cos, sin = math.cos(angle), math.sin(angle)
    return torch.stack([cos * n[:, 0] - sin * n[:, 1],
                        sin * n[:, 0] + cos * n[:, 1], n[:, 2]], dim=1)


@pytest.mark.parametrize("fault", ["none", "t_shifted_on_hits",
                                   "normals_rotated", "hit_ray_sent_past"])
def test_the_march_check_fails_each_planted_fault(march, fault):
    t, n, t_64, n_64 = march
    hit = t[:, 0] < kc.HIT_T
    assert 100 < int(hit.sum()) < t.shape[0]
    noise = kc.march_noise_tols(t, n, t_64, n_64)
    tols = {key: max(tol, noise[key]) for key, tol in kc.MARCH_TOLS.items()}
    t_k, n_k = t.clone(), n.clone()
    if fault == "t_shifted_on_hits":
        t_k[hit] += 0.05
    elif fault == "normals_rotated":
        n_k[hit] = _rotated(n[hit], 0.1)
    elif fault == "hit_ray_sent_past":
        t_k[int(torch.nonzero(hit)[0, 0])] = 40.0
    excess = kc.march_excess(kc.march_errors(t_k, n_k, t, n), tols)
    want = {"none": set(),
            "t_shifted_on_hits": {"max_abs_err_t_hit", "max_rel_err_t_all"},
            "normals_rotated": {"max_abs_err_normal_hit"},
            "hit_ray_sent_past": {"max_abs_err_t_hit",
                                  "max_rel_err_t_all"}}[fault]
    assert set(excess) == want, (excess, tols)


@pytest.mark.parametrize("term", ["bytes", "sfu", "fp32"])
def test_the_bound_is_named_by_its_larger_term(term):
    """1 ms of memory traffic against 2 ms of SFU or 3 ms of FP32 work (and
    a negligible other term): the bound is the larger, named by it."""
    nbytes = kc.HBM_BYTES_PER_S * 1e-3
    sfu = {"sfu": kc.SFU_OPS_PER_S * 2e-3}.get(term, 1.0)
    flops = {"fp32": kc.FP32_FLOP_PER_S * 3e-3}.get(term, 1.0)
    got = kc.bound(nbytes, sfu_ops=sfu, flops=flops)
    want = {"bytes": 1.0, "sfu": 2.0, "fp32": 3.0}[term]
    assert got["bound_ms"] == pytest.approx(want, rel=1e-9)
    assert got["bound_by"] == ("bytes" if term == "bytes" else "operations")


def test_frame_gaps_count_what_differs():
    """A frame against itself has no gap; one lit pixel turned black is one
    pixel lit in one frame only, and up to three channels more than 2 LSB
    off."""
    frame = np.random.default_rng(3).uniform(0.2, 1.0, (64, 3))
    same = kc.u8_gaps(frame, frame.copy())
    assert same == {"mean_lsb": 0.0, "share_over_2_lsb": 0.0,
                    "lit_mismatch_share": 0.0}
    dark = frame.copy()
    dark[5] = 0.0
    gaps = kc.u8_gaps(dark, frame)
    assert gaps["lit_mismatch_share"] == 1 / 64
    assert gaps["share_over_2_lsb"] == 3 / (64 * 3)
    assert gaps["mean_lsb"] > 0.0

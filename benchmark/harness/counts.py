"""The yardstick of the rooflines and the *_mfu shares: the card's peaks and
the operations each piece of work needs, counted from shapes and from the
live or valid (ray, primitive) pairs of its inputs, so that a count is the
same whatever implements the work.

The peaks are those of ``chip_smoke.py::bound`` (NVIDIA's data sheet for
one H100 SXM): HBM 3.35 TB/s, FP32 outside the tensor cores 67 TFLOP/s,
and the special-function units at 16 lanes a clock per SM, times the SMs,
times the card's maximum SM clock as ``nvidia-smi`` reports it. A piece of
work's least time is the largest of its special-function operations (one
sqrt, exp or reciprocal each) over the SFU rate, its other FP32 operations
over the FP32 rate, and its bytes over the memory rate.

Operations a pair, from the kernel table of ``PERF.md``:

* a field evaluation (one soft-min term: |p - c| - r and its exponential)
  is 2 SFU and 12 FP32 operations; a march of ``s`` steps with its final
  evaluation and 6-tap normals is ``s + 7`` evaluations (K1, K3);
* the shading tail forward (the reattached evaluation, the softmax weight
  and the coverage evaluation) is 5 SFU and 30 FP32 operations; K2's
  backward recomputes them, 5 SFU and 60 FP32 (its roofline); the whole
  step's count takes the forward only, since a backward need not
  recompute;
* a repulsion pair (K4) is 2 SFU (sqrt, reciprocal) and 12 FP32 forward,
  2 and 25 backward, over C·G·(W·G + C) pairs of a table of C clusters of
  G members with W near clusters and the member far field;
* the exact repulsion (config 1) is M² pairs, 2 SFU and 12 FP32 forward,
  2 and 25 backward.

Bytes are left out of the step counts: what a step must read (its rays and
its primitive table) is some megabytes, microseconds at 3.35 TB/s.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_LANES_PER_CLK_PER_SM = 16
EVAL_SFU, EVAL_FP32 = 2.0, 12.0
NORMAL_EVALS = 7
SHADE_FWD_SFU, SHADE_FWD_FP32 = 5.0, 30.0
SHADE_BWD_SFU, SHADE_BWD_FP32 = 5.0, 60.0
REP_FWD_SFU, REP_FWD_FP32 = 2.0, 12.0
REP_BWD_SFU, REP_BWD_FP32 = 2.0, 25.0


def card_peaks() -> dict:
    """The peaks of card 0: its SM count from torch and its maximum SM
    clock from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    mhz = float(out.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sfu_per_s": SFU_LANES_PER_CLK_PER_SM * sms * mhz * 1e6,
            "fp32_per_s": FP32_FLOP_PER_S, "bytes_per_s": HBM_BYTES_PER_S,
            "sms": sms, "max_sm_mhz": mhz}


class Work:
    """Operations and bytes of some piece of work."""

    def __init__(self, sfu: float = 0.0, fp32: float = 0.0,
                 nbytes: float = 0.0):
        self.sfu, self.fp32, self.nbytes = sfu, fp32, nbytes

    def __add__(self, other: "Work") -> "Work":
        return Work(self.sfu + other.sfu, self.fp32 + other.fp32,
                    self.nbytes + other.nbytes)

    def __mul__(self, n: float) -> "Work":
        return Work(self.sfu * n, self.fp32 * n, self.nbytes * n)

    def least_s(self, peaks: dict) -> float:
        return max(self.sfu / peaks["sfu_per_s"],
                   self.fp32 / peaks["fp32_per_s"],
                   self.nbytes / peaks["bytes_per_s"])


def march(pairs: float, steps: int) -> Work:
    """K1 or K3: ``steps`` march steps, the final evaluation and the
    normals over ``pairs`` (ray, live or valid primitive) pairs."""
    evals = pairs * (steps + NORMAL_EVALS)
    return Work(EVAL_SFU * evals, EVAL_FP32 * evals)


def shade_fwd(pairs: float) -> Work:
    return Work(SHADE_FWD_SFU * pairs, SHADE_FWD_FP32 * pairs)


def shade_bwd(pairs: float) -> Work:
    return Work(SHADE_BWD_SFU * pairs, SHADE_BWD_FP32 * pairs)


def cluster_repulsion_pairs(n_live: int, group: int, near: int) -> float:
    """Pairs of the two-level repulsion over ``n_live`` primitives in
    clusters of ``group`` with ``near`` near clusters and the member far
    field."""
    c = max(1, -(-n_live // group))
    w = min(near, c)
    return float(c * group * (w * group + c))


def repulsion_fwd(pairs: float) -> Work:
    return Work(REP_FWD_SFU * pairs, REP_FWD_FP32 * pairs)


def repulsion_bwd(pairs: float) -> Work:
    return Work(REP_BWD_SFU * pairs, REP_BWD_FP32 * pairs)

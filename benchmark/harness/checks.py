"""The output checks: the numbers a run compares with the plain reference,
each against its limit from ``limits/<workload>.json``.

Training (the first steps of a run, the program's against the reference's
on the same seed):

* ``loss_rel``: the largest gap of a step's loss, over the reference's;
* ``grad_gap``: the gradient as the optimizer holds it after the first step
  (its first moment over 1 - beta1), by the worst leaf: the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``delta_gap``: the same for each leaf's change over the checked steps;
* ``init_gap``: the largest difference of the stage-start parameters;
* ``draw_gap``: how many drawn batch indices differ.

The window's first stage boundary (density control from the program's
state at the end of the stage, then the next stage's first steps):

* ``density_count_gap``: how far density control's counts (primitives
  after it, kept, split, merged) lie from the reference's, summed;
* ``density_gap``: the largest difference of the raw parameters it
  returned (not finite where their shapes differ);
* ``loss_rel.s1``, ``grad_gap.s1``, ``delta_gap.s1``: the numbers above,
  over the next stage's first steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of ``grad_gap`` and ``delta_gap``: Adam moves them by round-off
alone.

The viewer (served frames against the reference's frames of the same
poses, both as decoded 8-bit images): ``frame_mean_lsb``, the largest mean
absolute difference of a frame in 8-bit steps, and ``frame_px_over_2lsb``,
the largest share of a frame's channel values more than 2 steps apart.
"""

from __future__ import annotations

import math
import statistics
import sys

import numpy as np
import torch

LEAVES = ("centers", "colors", "radii", "light_dir", "ambient")


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _worst_leaf(prog: dict, ref: dict, keep: list) -> float:
    n_p = {k: _norm(prog[k]) for k in keep}
    n_r = {k: _norm(ref[k]) for k in keep}
    med = statistics.median(n_r.values())
    worst = 0.0
    for k in keep:
        den = max(n_r[k], med)
        gap = abs(n_p[k] - n_r[k]) / den if den > 0 else (
            0.0 if n_p[k] == 0 else math.inf)
        worst = max(worst, gap)
    return worst


def compare_train(prog: dict, ref: dict) -> dict:
    """The training numbers of ``prog`` against ``ref``; each a dict of
    ``losses`` [floats], ``grad`` / ``p0`` / ``p3`` {leaf: tensor} and
    ``draws`` [tensors] (``p0`` and ``draws`` may be absent: the control
    and the planted faults start from the reference's own)."""
    lr = [float(x) for x in ref["losses"]]
    lp = [float(x) for x in prog["losses"]]
    loss_rel = max((abs(a - b) / abs(b) if b != 0 else abs(a))
                   for a, b in zip(lp, lr, strict=True))
    if not all(math.isfinite(x) for x in lp):
        loss_rel = math.inf
    g_r = {k: _norm(ref["grad"][k]) for k in LEAVES}
    med = statistics.median(g_r.values())
    keep = [k for k in LEAVES if g_r[k] >= 1e-3 * med]
    out = {"loss_rel": loss_rel,
           "grad_gap": _worst_leaf(prog["grad"], ref["grad"], keep),
           "delta_gap": _worst_leaf(
               {k: prog["p3"][k].double() - prog["p0"][k].double()
                for k in keep},
               {k: ref["p3"][k].double() - ref["p0"][k].double()
                for k in keep}, keep)}
    for key in ("grad_gap", "delta_gap"):
        if not math.isfinite(out[key]):
            out[key] = math.inf
    if "draws" in prog:
        out["init_gap"] = max(
            float((prog["p0"][k].double() - ref["p0"][k].double()).abs()
                  .max()) for k in LEAVES)
        out["draw_gap"] = float(sum(
            int((a.cpu() != b.cpu()).sum())
            for a, b in zip(prog["draws"], ref["draws"], strict=True)))
    return out


DENSITY_COUNTS = ("n_after", "kept", "split", "merged")


def compare_density(prog: dict, prog_counts: dict, ref: dict,
                    ref_counts: dict) -> dict:
    """Density control's numbers: ``prog`` / ``ref`` hold the returned raw
    ``centers``, ``colors`` and ``radii`` (tensors or arrays), the counts
    the keys of ``DENSITY_COUNTS``."""
    count_gap = sum(abs(int(prog_counts[k]) - int(ref_counts[k]))
                    for k in DENSITY_COUNTS)
    gap = 0.0
    for k in ("centers", "colors", "radii"):
        a = np.asarray(prog[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        if a.shape != b.shape:
            gap = math.inf
            break
        if a.size:
            d = float(np.abs(a - b).max())
            gap = max(gap, d) if math.isfinite(d) else math.inf
    return {"density_count_gap": float(count_gap), "density_gap": gap}


def compare_frames(prog: list, ref: list) -> dict:
    """The viewer numbers over pairs of [H, W, 3] uint8 frames."""
    mean_lsb, over = 0.0, 0.0
    for a, b in zip(prog, ref, strict=True):
        if a.shape != b.shape:
            return {"frame_mean_lsb": math.inf,
                    "frame_px_over_2lsb": math.inf}
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        mean_lsb = max(mean_lsb, float(d.mean()))
        over = max(over, float((d > 2).mean()))
    return {"frame_mean_lsb": mean_lsb, "frame_px_over_2lsb": over}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    that is not finite fails, and is given as null."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        finite = math.isfinite(value)
        ok = ok and finite and value <= limit
        checks[name] = {"value": value if finite else None, "limit": limit}
    return ok, checks


def print_checks(checks: dict) -> None:
    """Each number beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)

"""The yardstick of the data-parallel step's gradient all-reduce: its
bytes, the peak it is held to, and the time of its NCCL kernels in a
traced slice.

* Bytes: the program counts ``grad_mean.bytes``, the bytes one step
  all-reduces (every gradient and the loss, float32), at capture, and adds
  them per replay. A ring all-reduce over n ranks sends and receives
  2(n - 1)/n of them on each rank's busiest link direction (its bus
  bytes), whatever the algorithm NCCL picks for the size.
* Peak: the card's NVLink bandwidth in one direction, the sum of the
  speeds that ``nvidia-smi nvlink --status`` reports for the card's active
  links (each link's speed is per direction), read on the machine that
  runs the cell. On the four-card H100 machine it reads 18 links of
  26.562 GB/s, 478.1 GB/s; ``nvidia-smi topo -m`` does not run there
  ("Failed to run topology matrix"), so the peak takes the machine's word
  that its cards are joined all to all, and counts a ring's neighbour as
  reached at the card's whole NVLink bandwidth, the most it could be.
* Time: the device time of the NCCL kernels that the captured step's phase
  map puts in ``step.grad_mean``, over the replays of the traced slice
  that ``progtrace`` finds and attributes. NCCL's kernel waits inside for
  the slowest rank to arrive, so this time holds the ranks' imbalance.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess

from benchmark.harness import progtrace

PHASE = "step.grad_mean"
LINK_RE = re.compile(r"Link\s+\d+:\s+([0-9.]+)\s+GB/s")


def bus_bytes(nbytes: float, ranks: int) -> float:
    """The bytes a ring all-reduce of ``nbytes`` over ``ranks`` ranks moves
    in each direction of a rank's link."""
    return 2.0 * (ranks - 1) / ranks * nbytes


def link_bytes_per_s(status: str) -> float | None:
    """One direction's bytes a second of a card's NVLink: the sum of the
    active links' speeds in ``nvidia-smi nvlink --status`` output (None
    where it lists none)."""
    speeds = [float(x) for x in LINK_RE.findall(status)]
    return sum(speeds) * 1e9 if speeds else None


@functools.cache
def nvlink_peak(card: int = 0) -> float | None:
    """Card ``card``'s one-way NVLink bytes a second, as nvidia-smi reads
    it on this machine (None where it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "nvlink", "--status", "-i",
                              str(card)], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return link_bytes_per_s(out.stdout) if out.returncode == 0 else None


def grad_mean_nccl(run) -> dict | None:
    """Over the traced slice's attributed replays: {"nccl_s": the device
    seconds of NCCL kernels in ``step.grad_mean``, "bytes": the bytes they
    all-reduced, "steps"}, or None where nothing is attributed."""
    rec = progtrace.records(run)
    if rec is None or run.events is None:
        return None
    from burn_raymarching_tpu_torch.utils.profiling import attribute

    evs = list(run.events.clipped())
    names = [e[2] for e in evs]
    caps = {c["id"]: c for c in rec["captures"]}
    runs = progtrace._slice_runs(run, rec)
    blocks = progtrace._replay_blocks(names, runs, caps)
    # Captures whose replays have the same events (one step at one size)
    # are counted together, as progtrace counts them, if their maps agree.
    groups: dict = {}
    for span in runs:
        cid = span["attrs"].get("capture")
        if not blocks.get(cid) or cid not in caps:
            continue
        g = groups.setdefault(blocks[cid], {"n": 0, "maps": set()})
        g["n"] += span["attrs"].get("replays", 0)
        g["maps"].add(json.dumps([caps[cid]["phases"],
                                  caps[cid]["per_replay"]]))
    out = {"nccl_s": 0.0, "bytes": 0.0, "steps": 0}
    for block, g in groups.items():
        if len(g["maps"]) != 1:
            continue
        phases, per = json.loads(g["maps"].pop())
        skip = len(block) - sum(k for _, k in phases)
        for i in progtrace._find_blocks(names, list(block))[:g["n"]]:
            graph = evs[i + skip:i + len(block)]
            labels = attribute(graph, phases)
            if labels is None:
                continue
            out["nccl_s"] += sum(
                (b - a) / 1e6 for (a, b, name), ph in zip(graph, labels)
                if ph == PHASE and "nccl" in name.lower())
            out["bytes"] += per.get("grad_mean.bytes", 0)
            out["steps"] += per.get("steps", 0)
    if not out["steps"] or not out["bytes"] or out["nccl_s"] <= 0:
        return None
    return out


def roofline(run) -> float | None:
    """% of the all-reduce's roofline that its NCCL kernels reach on rank
    0 over the traced slice."""
    got = grad_mean_nccl(run)
    peak = nvlink_peak()
    if got is None or not peak:
        return None
    least_s = bus_bytes(got["bytes"], run.ranks) / peak
    return 100.0 * least_s / got["nccl_s"]

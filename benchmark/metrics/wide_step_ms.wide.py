"""wide_step_ms.wide (ms): device time per replayed step of the traced
slice's widest captured step: the captures whose ``trainer.capture`` span
names the most table ``rows`` (at config 5: stage 0, 51,200 spheres in
65,536 rows; the later stages' ~2,440 spheres pad to 4,096).

A replay's device events are found as ``progtrace.phase_times`` finds them
(its replay blocks: the events of one replay, learnt where they repeat).
Replays of other captures may have the same event names (one step at
another size): the slice's replays with those names are taken in the
order the program ran them, and the widest capture's are its own. Where
the occurrences do not match the replays one for one, nothing is guessed
and the reader returns None; so does a program whose captures name no
``rows``.
"""

from benchmark.harness import progtrace


def read(run):
    rec = progtrace.records(run)
    if rec is None or run.events is None:
        return None
    caps = {c["id"]: c for c in rec["captures"]}
    rows = {s["attrs"].get("capture"): s["attrs"]["rows"]
            for s in rec["spans"]
            if s["name"] == "trainer.capture" and "rows" in s["attrs"]}
    runs = progtrace._slice_runs(run, rec)
    here = {s["attrs"].get("capture") for s in runs} & set(rows) & set(caps)
    if not here:
        return None
    widest = max(rows[c] for c in here)
    ids = {c for c in here if rows[c] == widest}
    evs = list(run.events.clipped())
    names = [e[2] for e in evs]
    blocks = progtrace._replay_blocks(names, runs, caps)
    found = {blocks.get(c) for c in ids}
    if len(found) != 1 or None in found:
        return None
    (block,) = found
    owners = []
    for s in runs:
        cid = s["attrs"].get("capture")
        if blocks.get(cid) == block:
            owners += [cid in ids] * s["attrs"].get("replays", 0)
    starts = progtrace._find_blocks(names, list(block))
    if len(starts) != len(owners):
        return None
    cap = caps[min(ids)]
    skip = len(block) - sum(k for _, k in cap["phases"])
    seconds = sum(sum(b - a for a, b, _ in evs[i + skip:i + len(block)])
                  for i, mine in zip(starts, owners) if mine) / 1e6
    steps = owners.count(True) * cap["per_replay"].get("steps", 0)
    return 1000.0 * seconds / steps if steps else None

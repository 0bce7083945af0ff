"""The reader ``wide_step_ms.wide`` on a synthetic traced slice: the
widest capture's replays (the most table rows), though another capture's
have the same kernel names; nothing read where it cannot tell them
apart."""

import pytest

from benchmark.harness.manifest import metric_reader
from benchmark.tests.test_bench_progtrace import replays, span, traced_run


def _two_widths(rows2, drop_one=False):
    """A traced slice of stage 0's replays (capture 1, 65,536 rows) and,
    after a boundary, stage 1's (capture 2, ``rows2`` rows): the same
    kernel names, capture 2's events twice as long. ``drop_one`` loses
    one event of a replay."""
    first = replays(3)
    if drop_one:
        first = first[:-1]
    run = traced_run(
        [(replays(5), (1, 5)), (["read"], None), (first, (1, 3)),
         (["density", "prefill"], None), (replays(4), (2, 4))],
        extra_spans=[
            span(1, "trainer.capture", 0.5, 0.6, capture=1, stage=0,
                 rows=65536),
            span(2, "trainer.capture", 20.0, 20.1, capture=2, stage=1,
                 rows=rows2)])
    (boundary,) = [a for a, _, n in run.events.device if n == "density"]
    run.events.device = [(a, b + (b - a) if a > boundary else b, n)
                         for a, b, n in run.events.device]
    return run


@pytest.mark.parametrize("rows2,want", [(4096, 9e-3),
                                        (65536, 12e-3),
                                        (131072, 18e-3)],
                         ids=["fewer-rows", "same-rows", "more-rows"])
def test_wide_step_ms_reads_the_widest_captures_replays(rows2, want):
    """Device ms a replayed step (9 events of 1 µs; capture 2's 2 µs) of
    the captures with the most rows, though both captures' replays have
    the same kernel names (with as many rows, all 12 replays)."""
    read = metric_reader("wide_step_ms.wide")
    assert read(_two_widths(rows2)) == pytest.approx(want)


def test_wide_step_ms_reads_nothing_it_cannot_attribute():
    """No reading from a program whose captures name no rows, nor where a
    replay lost an event."""
    read = metric_reader("wide_step_ms.wide")
    assert read(_two_widths(4096, drop_one=True)) is None
    run = _two_widths(4096)
    for s in run.program["spans"]:
        s["attrs"].pop("rows", None)
    assert read(run) is None

"""empty_tile_share.train on a run's program records: the program's
``empty_tiles`` over its ``tiles``, and nothing from a program that does
not count empty tiles."""

import types

import pytest

from benchmark.harness.manifest import metric_reader


def _run(counters):
    return types.SimpleNamespace(events=None, program={
        "spans": [], "counters": counters, "captures": []})


def test_empty_tile_share_reads_the_programs_counters():
    read = metric_reader("empty_tile_share.train")
    assert read(_run({"tiles": 800, "table_slots": 1600,
                      "valid_entries": 300, "empty_tiles": 200})) == \
        pytest.approx(25.0)
    # A program without the counter (the parent of the change that added
    # it), and a run that counted no culled step.
    assert read(_run({"tiles": 800, "table_slots": 1600,
                      "valid_entries": 300})) is None
    assert read(_run({})) is None

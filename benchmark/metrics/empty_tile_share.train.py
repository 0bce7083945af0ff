"""empty_tile_share.train (%): the culled steps' tiles whose selection kept
no valid slot (the program's counter ``empty_tiles``) over every tile
counted (the host counter ``tiles``), over every step counted since the
tracer was switched on: set-up's checked steps and every job of the run,
as ``cull_fill.train`` reads. K3 marches such a tile against one masked
column. None where the program does not count empty tiles."""

from benchmark.harness import progtrace


def read(run):
    rec = progtrace.records(run)
    if rec is None:
        return None
    c = rec["counters"]
    if not c.get("tiles") or "empty_tiles" not in c:
        return None
    return 100.0 * c["empty_tiles"] / c["tiles"]

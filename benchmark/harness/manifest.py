"""BENCHMARK.json: its validation against the benchmark's contract, and
the discovery by name of what each cell is made of.

A cell ``<config>.<traffic>`` is found from four kinds of file, each the
property of one name, so that a new configuration, traffic mix, metric or
cell is added by adding files and entries, never by editing one:

* ``configs/<config>.json``: the configuration as it is run (the entry's
  ``file``);
* ``traffic/<traffic>.json``: the traffic mix, read by the one generator of
  its ``kind``, ``harness/<kind>.py`` (``train`` or ``view`` so far);
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(run)`` that returns a number, or None where it finds nothing;
* ``limits/<workload>.json``: the limits of the cell's output check.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# Words of a reduced key that make it a width, which is never cut.
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok", "num_experts_per")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def _inside(path: str, paths: list) -> bool:
    return any(path == p or path.startswith(p.rstrip("/") + "/")
               for p in paths)


def validate(m: dict, root: str = ROOT) -> list[str]:
    """Every way ``m`` breaks the contract, as messages (empty: sound)."""
    err = []
    if set(m) != TOP_KEYS:
        err.append(f"top-level keys {sorted(m)} != {sorted(TOP_KEYS)}")
        return err
    paths = m["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        err.append("paths: 1 to 16 directories")
        paths = []
    for p in paths:
        if (not isinstance(p, str) or not PATH_RE.match(p)
                or p.startswith("/") or ".." in p.split("/")):
            err.append(f"path {p!r} is not a plain relative path")
    cmd = m["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(_line(w) for w in cmd)):
        err.append("command: 1 to 32 words of 1 to 200 characters")
    else:
        for w in cmd:
            if w.startswith("/") or ".." in w.split("/"):
                err.append(f"command word {w!r} leaves the checkout")
            elif "/" in w and not _inside(w, paths):
                err.append(f"command word {w!r} names a file outside paths")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and not isinstance(rs, bool)
            and 1 <= rs <= 51):
        err.append("run_seconds: a whole number from 1 to 51")
    names: set = set()

    def name_ok(kind, n):
        if not isinstance(n, str) or not NAME_RE.match(n):
            err.append(f"{kind} name {n!r} is malformed")

    configs = m["configs"]
    if not (isinstance(configs, list) and 1 <= len(configs) <= 24):
        err.append("configs: 1 to 24 entries")
        configs = []
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            err.append(f"config {c.get('name')!r} keys {sorted(c)}")
            continue
        name_ok("config", c["name"])
        if not _line(c["source"]) or not (
                c["source"].startswith("http") or " " in c["source"]):
            err.append(f"config {c['name']}: source is no URL or paper")
        if not _line(c["why"]):
            err.append(f"config {c['name']}: why is not one line")
        if not _inside(c["file"], paths) or c["file"] in files:
            err.append(f"config {c['name']}: file not under paths or shared")
        files.add(c["file"])
        if not os.path.isfile(os.path.join(root, c["file"])):
            err.append(f"config {c['name']}: {c['file']} missing")
        red = c["reduced"]
        if not isinstance(red, list) or len(red) > 16:
            err.append(f"config {c['name']}: reduced has at most 16 keys")
            red = []
        for k in red:
            name_ok("reduced key", k)
            if (isinstance(k, str) and (k.endswith("_dim") or k.endswith(
                    "_rank") or any(w in k for w in WIDTH_WORDS))):
                err.append(f"config {c['name']}: reduced names a width {k}")
    cfg_names = {c.get("name") for c in configs}
    cells = m["workloads"]
    if not (isinstance(cells, list) and 1 <= len(cells) <= 24):
        err.append("workloads: 1 to 24 cells")
        cells = []
    pairs, used = set(), set()
    for w in cells:
        if set(w) != WORKLOAD_KEYS:
            err.append(f"workload {w.get('name')!r} keys {sorted(w)}")
            continue
        name_ok("workload", w["name"])
        name_ok("traffic", w["traffic"])
        if w["name"] in names:
            err.append(f"workload {w['name']} named twice")
        names.add(w["name"])
        if w["config"] not in cfg_names:
            err.append(f"workload {w['name']}: unknown config")
        used.add(w["config"])
        if (w["config"], w["traffic"]) in pairs:
            err.append(f"workload {w['name']}: config and traffic repeat")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            err.append(f"workload {w['name']}: chips is 1 or 4")
        if not _line(w["why"]):
            err.append(f"workload {w['name']}: why is not one line")
    if cfg_names - used:
        err.append(f"configs used by no cell: {sorted(cfg_names - used)}")
    four = sum(1 for w in cells if w.get("chips") == 4)
    if four > max(1, len(cells) // 4):
        err.append(f"{four} cells ask for 4 chips")
    cell_names = {w.get("name") for w in cells}
    e2e = m["end_to_end"]
    if not (isinstance(e2e, list) and 1 <= len(e2e) <= 16):
        err.append("end_to_end: 1 to 16 metrics")
        e2e = []
    e2e_names = set()
    for e in e2e:
        if not (E2E_KEYS <= set(e) <= E2E_KEYS | {"workloads"}):
            err.append(f"metric {e.get('name')!r} keys {sorted(e)}")
            continue
        err.extend(_metric_errors(e, names, cell_names))
        e2e_names.add(e["name"])
        b = e["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            err.append(f"metric {e['name']}: bound outside 0.01..0.25")
        if e["source"] not in ("host_clock", "device_trace"):
            err.append(f"metric {e['name']}: an end-to-end source is the "
                       f"host clock or the device trace")
    if "setup_s" not in e2e_names:
        err.append("end_to_end lacks setup_s")
    layers = m["per_layer"]
    if not (isinstance(layers, list) and 1 <= len(layers) <= 128):
        err.append("per_layer: 1 to 128 metrics")
        layers = []
    for p in layers:
        if not (LAYER_KEYS <= set(p) <= LAYER_KEYS | {"workloads"}):
            err.append(f"metric {p.get('name')!r} keys {sorted(p)}")
            continue
        err.extend(_metric_errors(p, names, cell_names))
        if not _line(p["layer"]):
            err.append(f"metric {p['name']}: layer is not one line")
        if p["moves"] not in e2e_names or p["moves"] == "setup_s":
            err.append(f"metric {p['name']}: moves {p['moves']!r}")
    for w in cells:
        e_here = [e["name"] for e in e2e if "name" in e
                  and w["name"] in e.get("workloads", [w["name"]])]
        p_here = [p["name"] for p in layers if "name" in p
                  and w["name"] in p.get("workloads", [w["name"]])]
        if "setup_s" not in e_here or len(e_here) < 2 or not p_here:
            err.append(f"workload {w['name']}: needs setup_s, another "
                       f"end-to-end metric and a per-layer metric")
        for p in layers:
            if w["name"] in p.get("workloads", []) and p.get(
                    "moves") not in e_here:
                err.append(f"workload {w['name']} lists {p['name']} but "
                           f"does not report {p['moves']}")
    if len(json.dumps(m)) > 64 * 1024:
        err.append("BENCHMARK.json is over 64 KiB")
    return err


def _metric_errors(e: dict, names: set, cell_names: set) -> list[str]:
    err = []
    if not isinstance(e["name"], str) or not NAME_RE.match(e["name"]):
        err.append(f"metric name {e['name']!r} is malformed")
    elif e["name"] in names:
        err.append(f"name {e['name']} is used twice")
    names.add(e["name"])
    if not isinstance(e["unit"], str) or not UNIT_RE.match(e["unit"]):
        err.append(f"metric {e['name']}: unit {e['unit']!r} is malformed")
    if e["better"] not in ("lower", "higher"):
        err.append(f"metric {e['name']}: better is lower or higher")
    if e["source"] not in SOURCES:
        err.append(f"metric {e['name']}: source {e['source']!r}")
    for w in e.get("workloads", []):
        if w not in cell_names:
            err.append(f"metric {e['name']}: unknown workload {w!r}")
    return err


class Cell:
    """What the harness needs of one workload, found by name."""

    def __init__(self, m: dict, workload: str, root: str = ROOT):
        by_name = {w["name"]: w for w in m["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        self.workload = by_name[workload]
        self.name = workload
        self.chips = self.workload["chips"]
        (self.config_entry,) = [c for c in m["configs"]
                                if c["name"] == self.workload["config"]]
        self.config = read_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic = read_json(traffic_path(self.workload["traffic"],
                                              root))
        self.end_to_end = [e for e in m["end_to_end"]
                           if workload in e.get("workloads", [workload])]
        self.per_layer = [p for p in m["per_layer"]
                          if workload in p.get("workloads", [workload])]
        self.limits = read_json(limits_path(workload, root))
        self.run_seconds = m["run_seconds"]


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_path(traffic: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "traffic", f"{traffic}.json")


def limits_path(workload: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "limits", f"{workload}.json")


def kind_module(kind: str, root: str = ROOT):
    """The generator of the traffic kind ``kind``: ``harness/<kind>.py``,
    a module with ``run`` (one run of a cell) and ``readings`` (the
    control's and the planted faults' check numbers)."""
    path = os.path.join(root, "benchmark", "harness", f"{kind}.py")
    if not (isinstance(kind, str) and NAME_RE.match(kind)
            and os.path.isfile(path)):
        raise ValueError(f"unknown traffic kind {kind!r}")
    if os.path.realpath(root) == os.path.realpath(ROOT):
        mod = importlib.import_module(f"benchmark.harness.{kind}")
    else:
        spec = importlib.util.spec_from_file_location(
            "benchmark_kind_" + re.sub(r"\W", "_", kind), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    if not (callable(getattr(mod, "run", None))
            and callable(getattr(mod, "readings", None))):
        raise ValueError(f"harness/{kind}.py is no traffic kind: it needs "
                         f"run and readings")
    return mod


def metric_reader(name: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""One run of one cell: the command line, the card checks, the result
line. ``benchmark/run.py`` is the entry point."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from benchmark.harness import checks, imports, manifest


def process_start() -> float:
    """Wall-clock time this process started (Linux: from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = float(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds. The program's own kernels
    build into burn_raymarching_tpu_torch/build/, also inside it."""
    base = os.path.join(manifest.ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", default="",
                   help="instead of a run: the control's and the planted "
                        "faults' check numbers (comma list: control, "
                        "half_batch, altered), printed as one JSON line")
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    set_cache_dirs()
    import torch

    cell = manifest.Cell(manifest.load(), args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"no result: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros((), device=device)

    def note(what: str) -> None:
        print(f"[bench] {what} at {time.time() - started:.2f} s",
              file=sys.stderr, flush=True)

    note("CUDA ready")
    mod = manifest.kind_module(cell.traffic["kind"])
    tmp = tempfile.mkdtemp(prefix="bench_")
    try:
        if args.readings:
            out = mod.readings(cell, args.seed, tmp, device,
                               args.readings.split(","))
            print(json.dumps({"workload": cell.name, "seed": args.seed,
                              "readings": out}))
            return 0
        res = mod.run(cell, args.seed, args.seconds, bool(args.trace), tmp,
                      device, note=note)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = result_line(cell, args, res, started, torch)
    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"no result: modules of {loaded} are loaded", file=sys.stderr)
        return 3
    checks.print_checks(line["checks"])
    print(json.dumps(line))
    return 0


def result_line(cell, args, res: dict, started: float, torch) -> dict:
    units = {e["name"]: e["unit"] for e in cell.end_to_end}
    metrics = {}
    if not args.trace:
        values = dict(res["metrics"])
        values["setup_s"] = res["setup_wall"] - started
        for name, unit in units.items():
            # "<base>.<part>" is the kind's <base>, under a name of the
            # cells that report it (their own bound).
            value = values[name] if name in values else values[
                name.split(".")[0]]
            metrics[name] = {"value": value, "unit": unit}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": None, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        run = res["trace"]
        if run.events is not None:
            device["busy_s"] = run.events.busy_s()
            device["window_s"] = run.events.window_s
            line["breakdown"] = {"device_ops": run.events.top_ops(),
                                 "idle_gaps": run.events.idle_gaps()}
        for p in cell.per_layer:
            value = (manifest.metric_reader(p["name"])(run)
                     if run.events is not None else None)
            if value is not None:
                metrics[p["name"]] = {"value": value, "unit": p["unit"]}
    ok, line["checks"] = checks.judge(res["numbers"], cell.limits)
    line["correct"] = ok
    return line

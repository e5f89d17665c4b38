"""The benchmark's driver: one run of one cell.

A cell of BENCHMARK.json names a configuration (its file of sizes), a
traffic mix (benchmark/traffic/<traffic>.json) and the chips it needs.
The traffic file names the entry that drives the program
(benchmark/harness/entries/<entry>.py) and the parameters of the one
general generator (harness/traffic.py); benchmark/limits/<cell>.json
holds the limits of the numbers that decide `correct`; each per-layer
metric is a reader, benchmark/metrics/<metric>.py. Everything is found by
the names in BENCHMARK.json, so a new cell, configuration, traffic mix or
metric is new files and new entries, never an edit.

A run: set-up (weights and inputs made from the seed on the device, the
entry's first steps, which also warm up every shape the window uses),
then the measured window of `seconds`, then with trace 1 a short
profiled tail, then the check against the plain reference, and one JSON
line.
"""

import importlib.util
import json
import math
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "unast_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """A module from a file, by path (the names of metric files hold
    dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of the manifest at `root`, with everything it names."""

    def __init__(self, root, name):
        self.root = root
        manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.spec["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        bench = os.path.join(root, "benchmark")
        self.traffic = load_json(os.path.join(
            bench, "traffic", self.spec["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench, "limits", name + ".json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.spec["chips"])

    def entry(self):
        path = os.path.join(self.root, "benchmark", "harness", "entries",
                            self.traffic["entry"] + ".py")
        return load_module(path, "bench_entry_" + self.traffic["entry"])

    def reader(self, metric):
        path = os.path.join(self.root, "benchmark", "metrics",
                            metric + ".py")
        return load_module(path, "bench_metric_" + metric.replace(".", "_"))


def forbidden_modules():
    """Loaded modules whose top-level name is one the port must not
    load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def refuse_forbidden():
    """Fail the run, naming them on standard error, where a module of JAX
    or of the JAX package is loaded: the last step before a result is
    printed, after the readers have run."""
    found = forbidden_modules()
    if found:
        print(f"modules of {', '.join(found)} are loaded in the process that "
              "measured: the port must not load them", file=sys.stderr)
        raise SystemExit(1)


def spread_line(win):
    """The window's spread on standard error: the host's seconds per unit
    of work (a step, a batch) at its quartiles, to tell the noise of a
    process from that of the machine."""
    times = win.get("unit_s")
    if times:
        import numpy as np
        q = np.quantile(times, [0.0, 0.25, 0.5, 0.75, 1.0])
        print(f"window: {len(times)} units in {win['seconds']:.3f} s, "
              "seconds a unit min/q1/median/q3/max "
              + " ".join(f"{x:.4f}" for x in q), file=sys.stderr)


def run(root, name, seed, seconds, trace, device="cuda", t0=None):
    """One run of cell `name` on `device` ('cuda'; the tests drive it on
    'cpu' at tiny sizes): the result line's dict. `t0`: the process's
    start on the host clock, where set-up begins."""
    import torch
    from . import flash_calls, tracing

    t0 = time.time() if t0 is None else t0
    cell = Cell(root, name)
    entry = cell.entry()
    state = entry.setup(cell, int(seed), device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t0

    win = entry.window(state, float(seconds))
    if device == "cuda":
        torch.cuda.synchronize()
    spread_line(win)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    records = {"window": win, "config": cell.config, "traffic": cell.traffic}
    if trace:
        records["trace"] = tracing.profile_tail(
            lambda: entry.tail(state), device)
        records["tail"] = dict(state.get("tail", {}))
        if "flash" in records["tail"]:
            records["tail"]["flash"] = flash_calls.resolve(
                records["tail"]["flash"])

    e2e = entry.end_to_end(state, win)
    e2e["peak_mem_gib"] = peak / 2 ** 30
    e2e["setup_s"] = setup_s

    checks = entry.judge(state, win)   # frees the program's state first

    # the numbers the cell's limits file names (a number with no upper
    # reading in a cell is not compared there)
    compared = {}
    correct = True
    for key, limit in cell.limits.items():
        value = checks[key]
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        compared[key] = {"value": value, "limit": limit}

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(records)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(win["attempted"]),
              "failed": int(win["failed"]),
              "metrics": metrics, "device": dev}
    if trace:
        t = records["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = compared
    refuse_forbidden()
    return result

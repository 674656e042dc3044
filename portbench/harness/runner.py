"""The run after the look for a card: set-up, window, readings, the result
line.  :func:`run` takes the device, so the harness's own tests drive a
whole run on the CPU at a small size."""

import gc
import json
import math
import sys
import time

import torch

from . import check, guard
from .cell import Cell, end_to_end
from .peaks import peaks


class RunView:
    """What a per-layer metric's reader sees: the cell's ``config`` and
    ``traffic``, the window's ``recordings`` (with the stage times of a
    traced run), the ``trace`` (``None`` where nothing was profiled) and the
    card's ``peak`` (``None`` for a card the peak table lacks)."""

    def __init__(self, cell, window, peak):
        self.config, self.traffic = cell.config, cell.traffic
        self.recordings, self.trace, self.peak = window.recordings, window.trace, peak


def _device(device, count, trace):
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"], info["window_s"] = trace.busy_s, trace.window_s
    return info


def _metric(value, unit):
    return {"value": value, "unit": unit}


def run(manifest, args, device, started, out=None, err=None):
    """One run of ``args.workload``; prints the result line and returns the
    exit code (3, and no result, where a forbidden module was loaded)."""
    out, err = out or sys.stdout, err or sys.stderr
    device = torch.device(device)
    faults = guard.reference_faults(manifest.home / "reference")
    if faults:
        print("portbench: a plain reference imports {}".format(faults), file=err)
        return 3
    before = set(sys.modules)
    cell = Cell(manifest, args.workload, args.seed, device)
    if guard.loaded([guard.PROGRAM], set(sys.modules) - before):
        print("portbench: the plain reference loaded the program", file=err)
        return 3
    cell.set_up(traced=bool(args.trace))
    setup_s = time.perf_counter() - started
    print("portbench: set-up {:.3f} s, of which the recordings {:.3f} s, the system {:.3f} s, the warm-up {:.3f} s".format(
        setup_s, *cell.setup_parts), file=err)
    window = cell.window(args.seconds, traced=bool(args.trace))
    info = _device(device, cell.cell["chips"], window.trace)

    workload = args.workload
    metrics = {}
    if args.trace:
        view = RunView(cell, window, peaks(info["kind"]))
        for m in manifest.per_layer(workload):
            value = manifest.reader(m["name"]).read(view)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        values = end_to_end(window, cell.config["sample_rate"])
        values["setup_s"] = setup_s
        for m in manifest.end_to_end(workload):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = _metric(values[m["name"]], m["unit"])

    if window.trace is not None:
        t = window.trace
        print("portbench: traced {} recordings, {} device activities, {} spans, busy {:.6f} of {:.6f} s".format(
            len(t.recordings), len(t.device), len(t.spans), t.busy_s, t.window_s), file=err)
    bad = [r["index"] for r in window.recordings if r["failed"]]
    if bad:
        print("portbench: recordings failed (raised or not finite): {}".format(bad[:20]), file=err)
    if window.error:
        print("portbench: a recording raised:\n" + window.error, file=err)
    attempted = len(window.recordings)
    failed = sum(1 for r in window.recordings if r["failed"])
    samples = window.samples
    breakdown = window.trace.breakdown() if window.trace is not None else None
    window = None
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(samples, cell.reference, cell.config, device)
    correct, table = check.judge(numbers, manifest.limits(workload))
    table["failed"] = {"value": failed, "limit": 0}
    correct = correct and failed == 0 and attempted > 0

    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    # last, after the readers and the comparison, so that whatever they
    # loaded is seen too
    found = guard.forbidden_loaded()
    if found:
        print("portbench: JAX or the JAX package was loaded: {}".format(", ".join(found)), file=err)
        return 3
    for name, entry in table.items():
        print("check {} {} limit {}".format(name, entry["value"], entry["limit"]), file=err)
    print(json.dumps(result, allow_nan=False), file=out)
    return 0

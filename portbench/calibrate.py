"""The readings a cell's comparison limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> ... [--control-seeds <n> ...]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at the cell's own load, then the four numbers of
:mod:`~portbench.harness.check` for the recordings drawn from it (the
program against the float64 reference) and, for a control seed, the same
numbers for the control (the reference computed with TF32 products, in the
program's place) on the same recordings.  One JSON line per reading, then
a summary: the lower reading of each number (the largest of the
program's) and the upper one (the smallest of the control's).  The
benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(manifest, workload, seeds, control_seeds, seconds, device, out):
    """``{"program": [numbers...], "control": [numbers...]}`` over the
    seeds, each reading printed to ``out`` as it comes."""
    import gc

    import torch

    from portbench.harness import check
    from portbench.harness.cell import Cell

    found = {"program": [], "control": []}
    for seed in seeds:
        cell = Cell(manifest, workload, seed, device)
        cell.set_up()
        window = cell.window(seconds)
        failed = sum(1 for r in window.recordings if r["failed"])
        samples = window.samples
        cell.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        runs = [("program", False)] + ([("control", True)] if seed in control_seeds else [])
        for who, control in runs:
            numbers = check.compare(samples, cell.reference, cell.config, device, control=control)
            found[who].append(numbers)
            line = {"seed": seed, "who": who, "attempted": len(window.recordings), "failed": failed, **numbers}
            print(json.dumps(line), file=out, flush=True)
    return found


def summary(found):
    """The lower and upper reading of each number."""
    from portbench.harness.check import NUMBERS

    return {
        name: {
            "lower": max((r[name] for r in found["program"]), default=None),
            "upper": min((r[name] for r in found["control"]), default=None),
        }
        for name in NUMBERS
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    import torch

    from portbench.harness.manifest import Manifest

    if not torch.cuda.is_available():
        print("portbench: no CUDA card is available", file=sys.stderr)
        return 2
    started = time.perf_counter()
    found = readings(Manifest(ROOT), args.workload, args.seeds, set(args.control_seeds), args.seconds, torch.device("cuda"), sys.stdout)
    print(json.dumps({"summary": summary(found), "seconds": time.perf_counter() - started}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for (``BENCHMARK.json``).  Set-up (counted in ``setup_s``: the imports,
the CUDA context, the cell's recordings made from the seed on the card,
the system under test and one warm-up separation), then the measured
window, then the comparison of recordings drawn from the window with the
plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit; the same numbers end standard error.

Exits 2 without a CUDA card or with fewer cards than the cell asks for,
and 3 when JAX or the JAX package was loaded; neither prints a result.
The kernels the program builds go to ``build/kernels/`` inside the
checkout, and any other build cache to ``build/portbench/`` there.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def fail(code, message):
    print("portbench: " + message, file=sys.stderr)
    return code


def main(argv=None):
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    from portbench.harness import guard
    from portbench.harness.manifest import Manifest

    if guard.forbidden_loaded():
        return fail(3, "loaded before the run: {}".format(", ".join(guard.forbidden_loaded())))
    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail(2, "no CUDA card is available; the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(2, "the cell asks for {} cards, {} found".format(cell["chips"], torch.cuda.device_count()))
    from portbench.harness.runner import run

    # one process with one CPU thread: the host path is the program's, and
    # idle worker threads only add noise
    torch.set_num_threads(1)

    return run(manifest, args, device="cuda", started=STARTED)


if __name__ == "__main__":
    sys.exit(main())

"""Drive a whole run of the harness on the CPU, skipping its look for a
card, with optional faults planted in the program underneath (the tests'
helper; not a test).

    python -m portbench.tests.cpu_run --root <checkout> --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--fault <name>]

Run from the checkout whose ``portbench`` is to be driven (the harness
finds its files under ``--root``).  Faults (:data:`FAULTS`): a solver step
that returns its state unchanged; the weighted covariances taken over half
of the frames, the mean over the rest; the separated waveform altered
where the program produces it.
"""

import argparse
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()


def unchanged_step(config):
    import audio_source_separation_tpu_torch as port

    getattr(port, config["system"]["entry"]).update_state = lambda self, state: dict(state)


def half_frames(config):
    from audio_source_separation_tpu_torch.ops import cov_kernel, ip_components

    whole = ip_components._covariance_planes

    def covariance(planes, weights):
        half = planes.shape[-1] // 2
        return whole(planes[..., :half], weights[..., :half])

    ip_components._covariance_planes = cov_kernel._covariance_planes = covariance


def altered_answer(config):
    import audio_source_separation_tpu_torch as port

    istft = port.istft

    def altered(*args, **kwargs):
        y = istft(*args, **kwargs)
        return y * 1.01

    port.istft = altered


FAULTS = {"unchanged_step": unchanged_step, "half_frames": half_frames, "altered_answer": altered_answer}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--fault", choices=sorted(FAULTS))
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from portbench.harness.manifest import Manifest
    from portbench.harness.runner import run

    torch.set_num_threads(2)

    manifest = Manifest(root)
    if args.fault:
        FAULTS[args.fault](manifest.config(manifest.workload(args.workload)["config"]))
    return run(manifest, args, device="cpu", started=STARTED)


if __name__ == "__main__":
    sys.exit(main())

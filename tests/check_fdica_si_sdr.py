"""Both packages' FDICA on chip_smoke.py's mixture, for the SI-SDR bar.

    python tests/check_fdica_si_sdr.py

A one-off check, not a test: ``GradLaplaceFDICA(lr=0.1)`` and
``NaturalGradLaplaceFDICA(lr=0.1)`` for 100 iterations on ``chip_smoke.py``'s
seeded 60 s 2-source mixture (2 x 2049 x 469 at stft(4096, 2048)), the JAX
package and the port both at float64 on the CPU, each with its permutation
alignment.  Prints one JSON line per class: the largest relative gap
between the two loss trajectories, whether the aligned filters agree, and
each package's SI-SDR before and after (best pairing, mic-0 images).
"""

import json
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import audio_source_separation_tpu as jax_package  # noqa: E402
import audio_source_separation_tpu_torch as port  # noqa: E402
import chip_smoke  # noqa: E402

ITERATIONS = 100


def run(package, name, mixture, **device):
    X = package.stft(mixture, fft_size=chip_smoke.FFT_SIZE, hop_size=chip_smoke.HOP_SIZE, **device)
    solver = getattr(package.models, name)(lr=0.1, **device)
    Y = solver(X, iteration=ITERATIONS)
    y = package.istft(Y, fft_size=chip_smoke.FFT_SIZE, hop_size=chip_smoke.HOP_SIZE, length=mixture.shape[-1], **device)
    return np.asarray(solver.loss), np.asarray(solver.demix_filter), np.asarray(y)


def main():
    rng = np.random.RandomState(chip_smoke.SEED)
    mixture, images = chip_smoke.synth_mixture(rng, 2, chip_smoke.N_SAMPLES)  # chip_smoke's phase-3 mixture
    for name in ("GradLaplaceFDICA", "NaturalGradLaplaceFDICA"):
        loss_jax, W_jax, y_jax = run(jax_package, name, mixture)
        loss_port, W_port, y_port = run(port, name, mixture, device="cpu")
        print(json.dumps({
            "class": name,
            "iterations": ITERATIONS,
            "loss_max_rel_gap": float(np.max(np.abs(loss_port - loss_jax) / np.abs(loss_jax))),
            "aligned_filter_max_abs_gap": float(np.max(np.abs(W_port - W_jax))),
            "si_sdr_before_db": chip_smoke.best_pairing_si_sdr(mixture, images),
            "si_sdr_after_db": {
                "jax": chip_smoke.best_pairing_si_sdr(y_jax, images),
                "port": chip_smoke.best_pairing_si_sdr(y_port, images),
            },
        }), flush=True)


if __name__ == "__main__":
    main()

"""Both packages' GaussILRMA with partitioning on chip_smoke.py's mixture.

    python tests/check_ilrma_partitioning.py

A one-off check, not a test: ``GaussILRMA(n_basis=10, partitioning=True)``
for 20 iterations on ``chip_smoke.py``'s seeded 60 s 2-source mixture (2 x
2049 x 469 at stft(4096, 2048)), the JAX package and the port both at
float64 on the CPU from the same seed-111 init.  Prints one JSON line: the
largest relative gap between the two loss trajectories and each package's
SI-SDR before and after (best pairing, mic-0 images).
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

ITERATIONS = 20


def run(package, mixture, **device):
    X = package.stft(mixture, fft_size=chip_smoke.FFT_SIZE, hop_size=chip_smoke.HOP_SIZE, **device)
    np.random.seed(chip_smoke.SEED)
    solver = package.models.GaussILRMA(n_basis=10, partitioning=True, **device)
    Y = solver(X, iteration=ITERATIONS)
    y = package.istft(Y, fft_size=chip_smoke.FFT_SIZE, hop_size=chip_smoke.HOP_SIZE, length=mixture.shape[-1], **device)
    return list(X.shape), np.asarray(solver.loss), np.asarray(y)


def main():
    rng = np.random.RandomState(chip_smoke.SEED)
    mixture, images = chip_smoke.synth_mixture(rng, 2, chip_smoke.N_SAMPLES)  # chip_smoke's phase-3 mixture
    shape, loss_jax, y_jax = run(jax_package, mixture)
    _, loss_port, y_port = run(port, mixture, device="cpu")
    print(json.dumps({
        "shape": shape,
        "iterations": ITERATIONS,
        "loss_max_rel_gap": float(np.max(np.abs(loss_port - loss_jax) / np.abs(loss_jax))),
        "loss_first_last": {"jax": loss_jax[[0, -1]].tolist(), "port": loss_port[[0, -1]].tolist()},
        "si_sdr_before_db": chip_smoke.best_pairing_si_sdr(mixture, images),
        "si_sdr_after_db": {
            "jax": chip_smoke.best_pairing_si_sdr(y_jax, images),
            "port": chip_smoke.best_pairing_si_sdr(y_port, images),
        },
    }))


if __name__ == "__main__":
    main()

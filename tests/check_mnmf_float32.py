"""Where MNMF's float32 runs leave float64, on chip_smoke.py's mixture.

    python tests/check_mnmf_float32.py

A one-off check, not a test (a few minutes on the CPU).  Prints one JSON
line per reading:

  * ``ozerov``: ``MultichannelISNMF(author="Ozerov", n_basis=10)``, 20
    losses from the seed-111 init on ``chip_smoke.py``'s seeded 60 s
    2-source mixture (2 x 2049 x 469 at stft(4096, 2048)), the port on the
    CPU at float32, at float64, and at float64 with float32's machine
    constants in the guards (the noise floor ``100 eps``, the ridges and
    floors): the largest relative gap of each pair of loss trajectories, so
    the guards' share of the float32 gap stands apart from rounding's;
  * ``sawada``: ``MultichannelISNMF(n_basis=10)`` x 10 on the same mixture
    at float32 and float64: the first loss's gap, the largest gap of the
    increments ``L_k - L_0`` relative to ``|L_0|``, and the output's largest
    gap relative to its largest entry, with the bins where it is largest;
  * ``fast_mnmf_10s``: ``FastMultichannelISNMF(n_basis=10)`` x 100 at
    float32 on the mixture cut to 10 s (2 x 2049 x 80), in both packages on
    the CPU: the index of the first non-finite loss, or None.
"""

import json
import os
import sys
import warnings
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import audio_source_separation_tpu.models as jax_models  # noqa: E402
import audio_source_separation_tpu_torch as port  # noqa: E402
import chip_smoke  # noqa: E402

N_LOSSES, ITERATIONS_FAST, FRAMES_CUT = 20, 100, 80
finfo = torch.finfo


def mixture(n_samples):
    rng = np.random.RandomState(chip_smoke.SEED)
    mix, _ = chip_smoke.synth_mixture(rng, 2, n_samples)
    return mix


def spectrogram(mix, dtype):
    return port.stft(mix.astype(dtype), fft_size=chip_smoke.FFT_SIZE, hop_size=chip_smoke.HOP_SIZE, device="cpu")


def sawada(X):
    np.random.seed(chip_smoke.SEED)
    solver = port.MultichannelISNMF(n_basis=10, device="cpu")
    Y = solver(X, iteration=10)
    return np.asarray(solver.loss), Y.to(torch.complex128)


def ozerov_losses(X):
    np.random.seed(chip_smoke.SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        solver = port.MultichannelISNMF(n_basis=10, author="Ozerov", device="cpu")
    solver(X, iteration=N_LOSSES - 1)
    return np.asarray(solver.loss)


class Float32Constants:
    """``torch.finfo`` stand-in giving float32's ``eps`` and ``tiny`` at any
    type: the guards' constants without float32's rounding."""

    def __init__(self, dtype):
        self.eps, self.tiny = finfo(torch.float32).eps, finfo(torch.float32).tiny


def max_gap(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def first_non_finite(loss):
    bad = ~np.isfinite(np.asarray(loss))
    return int(np.argmax(bad)) if bad.any() else None


if __name__ == "__main__":
    mix = mixture(chip_smoke.N_SAMPLES)
    f32 = ozerov_losses(spectrogram(mix, np.float32))
    X64 = spectrogram(mix, np.float64)
    f64 = ozerov_losses(X64)
    torch.finfo = Float32Constants
    try:
        f64_guards32 = ozerov_losses(X64)
    finally:
        torch.finfo = finfo
    print(json.dumps({"ozerov": {
        "losses": N_LOSSES,
        "float32_vs_float64": max_gap(f32, f64),
        "float64_with_float32_guards_vs_float64": max_gap(f64_guards32, f64),
        "float32_vs_float64_with_float32_guards": max_gap(f32, f64_guards32),
    }}), flush=True)

    (L32, Y32), (L64, Y64) = sawada(spectrogram(mix, np.float32)), sawada(X64)
    per_bin = ((Y32 - Y64).abs().amax(dim=(0, 2)) / Y64.abs().max()).numpy()
    print(json.dumps({"sawada": {
        "iterations": 10,
        "first_loss_float32_vs_float64": float(abs(L32[0] - L64[0]) / abs(L64[0])),
        "increments_float32_vs_float64": float(np.max(np.abs((L32 - L32[0]) - (L64 - L64[0]))) / abs(L64[0])),
        "output_float32_vs_float64": float(per_bin.max()),
        "worst_bins": np.argsort(per_bin)[::-1][:5].tolist(),
    }}), flush=True)

    cut = mixture(chip_smoke.HOP_SIZE * (FRAMES_CUT - 1))
    X = spectrogram(cut, np.float32)
    np.random.seed(chip_smoke.SEED)
    ours = port.FastMultichannelISNMF(n_basis=10, device="cpu")
    ours(X, iteration=ITERATIONS_FAST)
    np.random.seed(chip_smoke.SEED)
    ref = jax_models.FastMultichannelISNMF(n_basis=10)
    ref(X.numpy(), iteration=ITERATIONS_FAST)
    print(json.dumps({"fast_mnmf_10s": {
        "shape": list(X.shape), "iterations": ITERATIONS_FAST,
        "port_first_non_finite_loss": first_non_finite(ours.loss),
        "jax_first_non_finite_loss": first_non_finite(ref.loss),
    }}), flush=True)

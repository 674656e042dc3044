"""Where the float32 runs of LDPSDTF and CovarianceISNMF fail the sample-song
holds on the synthetic spectra of ``tests/test_torch_dynamic_range.py``.

    python tests/check_dynamic_range_float32.py

A one-off check, not a test (under a minute on the CPU).  Prints one JSON
line per model and package, at float32 and float64: the first and last
loss, the index of the first non-finite loss (or None), and the largest
step ``(L_k+1 - L_k) / |L_k|`` with its index.  The sample-song test holds
LDPSDTF's steps to 1e-5 and CovarianceISNMF's to 0.05.
"""

import json
import os
import sys
import warnings
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import audio_source_separation_tpu.models as jax_models  # noqa: E402
import audio_source_separation_tpu_torch as port  # noqa: E402
from test_torch_dynamic_range import _gram, _run, _spectra  # noqa: E402


def reading(model, package, dtype, loss):
    finite = np.isfinite(loss)
    steps = np.diff(loss) / np.abs(loss[:-1])
    return {
        "model": model, "package": package, "dtype": dtype, "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
        "first_non_finite": None if finite.all() else int(np.argmin(finite)),
        "max_step": float(np.nanmax(steps)), "at": int(np.nanargmax(steps)),
    }


def main():
    warnings.simplefilter("ignore")
    for dtype in (np.float32, np.float64):
        gram = _gram(dtype)
        for package, make in (("jax", lambda: jax_models.LDPSDTF(n_basis=2)),
                              ("port", lambda: port.LDPSDTF(n_basis=2, device="cpu"))):
            loss, _ = _run(make, gram, 50, cast_init=dtype == np.float32)
            print(json.dumps(reading("LDPSDTF", package, dtype.__name__, loss)), flush=True)
    for dtype in (np.complex64, np.complex128):
        X = _spectra(3).astype(dtype)
        cov = np.einsum("cft,dft->ftcd", X, X.conj())
        for package, make in (("jax", lambda: jax_models.CovarianceISNMF(n_basis=10)),
                              ("port", lambda: port.CovarianceISNMF(n_basis=10, device="cpu"))):
            loss, _ = _run(make, cov, 40, cast_init=False)
            print(json.dumps(reading("CovarianceISNMF", package, dtype.__name__, loss)), flush=True)


if __name__ == "__main__":
    main()

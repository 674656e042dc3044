"""Float32 dynamic-range regressions of the factorisation and MNMF solvers
in both packages, on seeded synthetic spectra spanning more than ten
decades of power (``tests/test_sample_song.py:218-340`` holds the JAX
package to the same on a recording that is not always present).

Each case runs the JAX package and the port at float32 from the same
seed-111 init and holds both to what the sample-song test holds: finite
losses and outputs, and the loss non-increasing where it says so.  Two
holds fail at float32 in both packages on these spectra (ROADMAP.md
section 3; ``python tests/check_dynamic_range_float32.py`` prints the
readings): LDPSDTF's per-step bound (one step rises by 1.1e-3 of the loss
in both) and CovarianceISNMF (JAX's loss turns NaN, the port's rises).
Those two are held at float64 in both packages, where each holds, and
LDPSDTF's float32 runs to what still holds there."""

import warnings

import numpy as np
import pytest

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port

from _torch_port import to_np

N_BINS, N_FRAMES, N_CHANNELS = 129, 48, 2


def _spectra(seed=0):
    """``(C, F, T)`` complex64 mixture of two sources whose power spans
    more than ten decades: spectral envelopes falling 1e0 -> 1e-8 over the
    bins, activations with near-silent frames (1e-4 in amplitude), and
    per-bin mixing filters."""
    rng = np.random.RandomState(seed)
    envelope = np.logspace(0, -8, N_BINS)[None, :, None] * np.abs(rng.randn(2, 1, 1) + 1)
    activation = np.abs(rng.randn(2, 1, N_FRAMES)) + 0.1
    activation[0, :, : N_FRAMES // 4] = 1e-4
    activation[1, :, -N_FRAMES // 4 :] = 1e-4
    S = np.sqrt(envelope * activation ** 2) * (rng.randn(2, N_BINS, N_FRAMES) + 1j * rng.randn(2, N_BINS, N_FRAMES))
    A = rng.randn(N_BINS, N_CHANNELS, 2) + 1j * rng.randn(N_BINS, N_CHANNELS, 2)
    X = np.einsum("fcn,nft->cft", A, S)
    power = np.abs(X) ** 2
    assert np.log10(power.max() / power.min()) > 10
    return X.astype(np.complex64)


def _float32(kwargs):
    return {k: np.asarray(v, dtype=np.complex64 if np.iscomplexobj(v) else np.float32) for k, v in kwargs.items()}


def _run(make, target, iteration, cast_init=True):
    """``make()`` on ``target`` (at its precision) from the seed-111 init,
    the init cast to float32 where ``cast_init``."""
    np.random.seed(111)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = make()
        # the port's preparation takes the input as its call does, a tensor
        prepared = model._to_input(target) if hasattr(model, "_to_input") else target
        kwargs = _float32(model.prepare_state_kwargs(prepared, {})) if cast_init else {}
        out = model(target, iteration=iteration, **kwargs)
    return np.asarray(model.loss), [to_np(a) for a in (out if isinstance(out, tuple) else (out,))]


def _finite(loss, outputs):
    assert np.isfinite(loss).all()
    assert all(np.isfinite(a).all() for a in outputs)


def _both(make_jax, make_port, target, iteration, cast_init=True):
    results = {
        "jax": _run(make_jax, target, iteration, cast_init),
        "port": _run(make_port, target, iteration, cast_init),
    }
    for loss, outputs in results.values():
        _finite(loss, outputs)
    return results


def test_ozerov_float32_dynamic_range():
    X = _spectra()
    results = _both(
        lambda: jax_models.MultichannelISNMF(n_basis=4, author="Ozerov"),
        lambda: port.MultichannelISNMF(n_basis=4, author="Ozerov", device="cpu"),
        X, 60, cast_init=False,
    )
    for loss, _ in results.values():
        assert loss[-1] < loss[0]
        d = np.diff(loss)
        if (d > 0).any():  # float32 EM jitter, not a spike
            assert d.max() < 0.15 * (loss.max() - loss.min())


def _gram(dtype):
    """Frame Grams ``(16, 16, 120)`` of a signal whose amplitude falls over
    five decades (power over ten), scaled and ridged as the sample-song
    test's."""
    rng = np.random.RandomState(1)
    B, hop, T = 16, 16, 120
    x = np.logspace(0, -5, T * hop) * rng.randn(T * hop)
    frames = np.stack([x[i * hop : i * hop + B] for i in range(T)])
    gram = np.einsum("ti,tj->ijt", frames, frames) * 1e4
    return (gram + 1e-3 * np.eye(B)[:, :, None]).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ldpsdtf_dynamic_range(dtype):
    gram = _gram(dtype)
    traces = np.einsum("iit->t", gram)
    assert np.log10(traces.max() / traces.min()) > 5
    results = _both(lambda: jax_models.LDPSDTF(n_basis=2), lambda: port.LDPSDTF(n_basis=2, device="cpu"), gram, 50,
                    cast_init=dtype == np.float32)
    for loss, _ in results.values():
        assert loss[-1] < loss[0]
        if dtype == np.float64:  # at float32 one step rises in both packages (ROADMAP.md section 3)
            assert (np.diff(loss) <= np.abs(loss[:-1]) * 1e-5).all()


@pytest.mark.parametrize("name", ["ISNMF", "EUCNMF", "KLNMF", "TNMF", "CauchyNMF", "ComplexEUCNMF", "EUCNTF"])
def test_factorisers_float32_dynamic_range(name):
    X = _spectra(2)
    if name == "ComplexEUCNMF":
        target = X[0]
    elif name == "EUCNTF":
        target = (np.abs(X) ** 2).astype(np.float32)
    else:
        target = (np.abs(X[0]) ** 2).astype(np.float32)
    results = _both(
        lambda: getattr(jax_models, name)(n_basis=10), lambda: getattr(port, name)(n_basis=10, device="cpu"),
        target, 30,
    )
    if name not in ("ComplexEUCNMF", "CauchyNMF"):  # neither is monotone (tests/test_sample_song.py)
        for loss, _ in results.values():
            assert (np.diff(loss) <= np.abs(loss[:-1]) * 1e-4 + 1e-12).all()


def test_covariance_isnmf_dynamic_range_at_float64():
    """At float32 both packages fail here (ROADMAP.md section 3)."""
    X = _spectra(3).astype(np.complex128)
    cov = np.einsum("cft,dft->ftcd", X, X.conj())
    results = _both(
        lambda: jax_models.CovarianceISNMF(n_basis=10), lambda: port.CovarianceISNMF(n_basis=10, device="cpu"),
        cov, 40, cast_init=False,
    )
    for loss, _ in results.values():
        assert loss[-1] < loss[0]
        assert (np.diff(loss) <= np.abs(loss[:-1]) * 0.05).all()

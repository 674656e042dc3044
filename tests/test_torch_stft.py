"""The port's STFT frontend and projection-back against the JAX package and
scipy (float64 on the CPU, 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from audio_source_separation_tpu.algorithm.projection_back import projection_back as j_projection_back
from audio_source_separation_tpu.transform import stft as j_stft
from audio_source_separation_tpu.transform.stft import build_optimal_window as j_build_optimal_window
from audio_source_separation_tpu.transform.stft import istft as j_istft
from audio_source_separation_tpu_torch import (
    apply_projection_back,
    build_optimal_window,
    build_window,
    istft,
    projection_back,
    stft,
)

from conftest import make_mixture

CASES = [(512, 256, 4000), (256, 64, 1500), (128, 48, 1001)]


@pytest.mark.parametrize("fft_size,hop_size,n_samples", CASES)
def test_stft_matches_scipy_and_jax(rng, fft_size, hop_size, n_samples):
    x = rng.randn(2, n_samples)
    ours = stft(x, fft_size=fft_size, hop_size=hop_size, device="cpu").numpy()
    _, _, ref = scipy.signal.stft(x, nperseg=fft_size, noverlap=fft_size - hop_size)
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours, np.asarray(j_stft(x, fft_size=fft_size, hop_size=hop_size)), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("fft_size,hop_size,n_samples", CASES)
def test_istft_matches_scipy_and_jax(rng, fft_size, hop_size, n_samples):
    x = rng.randn(2, n_samples)
    _, _, X = scipy.signal.stft(x, nperseg=fft_size, noverlap=fft_size - hop_size)
    ours = istft(X, fft_size=fft_size, hop_size=hop_size, device="cpu").numpy()
    _, ref = scipy.signal.istft(X, nperseg=fft_size, noverlap=fft_size - hop_size)
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        ours, np.asarray(j_istft(X, fft_size=fft_size, hop_size=hop_size)), rtol=1e-10, atol=1e-12
    )


def test_round_trip_with_length(rng):
    x = rng.randn(3, 2345)
    X = stft(torch.as_tensor(x), fft_size=256, hop_size=128, device="cpu")
    y = istft(X, fft_size=256, hop_size=128, length=x.shape[-1], device="cpu")
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), x, atol=1e-10)


@pytest.mark.parametrize("device", ["cpu"])
def test_windows(device):
    for fn in ("hann", "hamming", "boxcar"):
        w = build_window(64, window_fn=fn, device=device).numpy()
        np.testing.assert_allclose(w, scipy.signal.get_window(fn, 64), rtol=1e-12, atol=1e-15)
    w = build_window(64, device=device)
    expected = np.asarray(j_build_optimal_window(jnp.asarray(w.numpy()), hop_size=16))
    np.testing.assert_allclose(build_optimal_window(w, hop_size=16).numpy(), expected, rtol=1e-12)
    # a NumPy window goes to ``device``; a tensor stays where it is
    optimal = build_optimal_window(w.numpy(), hop_size=16, device=device)
    assert optimal.device.type == device
    np.testing.assert_allclose(optimal.numpy(), expected, rtol=1e-12)


def test_build_window_defaults_to_cuda(monkeypatch):
    """``build_window`` and ``build_optimal_window`` of a NumPy window run on
    the card unless asked for the CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_window(64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_optimal_window(np.hanning(64), hop_size=16)
    assert build_optimal_window(build_window(64, device="cpu"), hop_size=16).device.type == "cpu"


@pytest.mark.parametrize("n_sources", [2, 3, 4])
def test_projection_back_matches_jax(rng, n_sources):
    Y = make_mixture(rng, n_channels=n_sources, n_bins=15, n_frames=40)
    X = make_mixture(rng, n_channels=n_sources, n_bins=15, n_frames=40)
    for reference in (X[0], X):
        ours = projection_back(torch.as_tensor(Y), torch.as_tensor(reference)).numpy()
        ref = np.asarray(j_projection_back(jnp.asarray(Y), jnp.asarray(reference)))
        np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
    scaled = apply_projection_back(torch.as_tensor(Y), torch.as_tensor(X[0])).numpy()
    np.testing.assert_allclose(scaled, Y * np.asarray(j_projection_back(jnp.asarray(Y), jnp.asarray(X[0])))[..., None], rtol=1e-10)

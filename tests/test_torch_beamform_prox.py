"""The port's beamformers and ProxLaplaceIVA against the JAX package on the
CPU at float64: every beamformer function and class (atol 1e-10), and
ProxLaplaceIVA's whole loss trajectory (rtol 1e-9), filter, dual and output
(atol 1e-8) at C = 2 (the closed-form shrinkage) and C = 3 (the SVD); then
warm start, checkpoints (a JAX one too), callbacks and the raises."""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import state_from_jax

from _torch_port import to_np
from conftest import make_mixture

ITERATIONS = 8


def _steering_setup(rng, n_bins=17, n_channels=3, n_frames=48, n_sources=2):
    """Point sources with known steering vectors plus white noise
    (``tests/test_fdica_beamform_prox.py``'s setup, with ``n_sources``)."""
    a = np.exp(2j * np.pi * rng.rand(n_bins, n_channels, n_sources)) / np.sqrt(n_channels)
    s = rng.randn(n_sources, n_bins, n_frames) + 1j * rng.randn(n_sources, n_bins, n_frames)
    noise = 0.1 * (rng.randn(n_channels, n_bins, n_frames) + 1j * rng.randn(n_channels, n_bins, n_frames))
    X = np.einsum("fcs,sft->cft", a, s) + noise
    return X, a, s


def _covariances(a, s):
    """Each source's rank-1 spatial covariance ``(S, F, C, C)``."""
    return np.einsum("fcs,fds,sf->sfcd", a, a.conj(), np.mean(np.abs(s) ** 2, axis=-1))


def _function_cases(rng):
    X, A, s = _steering_setup(rng)
    R = np.mean(X.transpose(1, 0, 2)[:, :, None] * X.transpose(1, 0, 2)[:, None].conj(), axis=-1)
    Rs = _covariances(A, s)
    return {
        "delay_sum": ((X, A), {"reference_id": 1}),
        "ml": ((X, A, R + 0.1 * np.eye(3)), {}),
        "mvdr": ((X, A), {}),
        "mvdr_covariance": ((X, A), {"covariance": R}),
        "max_snr": ((X, Rs[0], Rs[1] + 0.01 * np.eye(3)), {"reference_id": 2}),
    }


FUNCTIONS = {
    "delay_sum": "delay_sum_beamform",
    "ml": "ml_beamform",
    "mvdr": "mvdr_beamform",
    "mvdr_covariance": "mvdr_beamform",
    "max_snr": "max_snr_beamform",
}


@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_beamform_functions_match_jax(rng, case):
    args, kwargs = _function_cases(rng)[case]
    name = FUNCTIONS[case]
    expected = np.asarray(getattr(jax_models, name)(*args, **kwargs))
    out = getattr(port, name)(*[torch.as_tensor(a) for a in args], **{
        k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()
    })
    np.testing.assert_allclose(to_np(out), expected, atol=1e-10)


@pytest.mark.parametrize("name", ["DelaySumBeamformer", "MVDRBeamformer", "MaxSNRBeamformer"])
def test_beamformer_classes_match_jax(rng, name):
    X, A, s = _steering_setup(rng)
    if name == "MaxSNRBeamformer":
        Rs = _covariances(A, s)
        call = dict(signal_covariance=Rs[1], noise_covariance=Rs[0] + 0.01 * np.eye(3))
        ref, ours = jax_models.MaxSNRBeamformer(), port.MaxSNRBeamformer(device="cpu")
    else:
        call = {}
        ref, ours = getattr(jax_models, name)(steering_vector=A), getattr(port, name)(steering_vector=A, device="cpu")
    expected = np.asarray(ref(X, **call))
    Y = ours(X, **call)
    assert Y.dtype == torch.complex128 and Y.device.type == "cpu"
    np.testing.assert_allclose(to_np(Y), expected, atol=1e-10)
    np.testing.assert_allclose(to_np(ours.estimation), expected, atol=1e-10)


def test_mvdr_honours_the_covariance(rng):
    X, A, _ = _steering_setup(rng)
    Xb = X.transpose(1, 0, 2)
    R = np.mean(Xb[:, :, None] * Xb[:, None].conj(), axis=-1)
    bf = port.MVDRBeamformer(steering_vector=A, device="cpu")
    np.testing.assert_allclose(to_np(bf(X, covariance=R)), to_np(bf(X)), atol=1e-12)


@pytest.mark.parametrize("given_covariance", [False, True])
def test_mvdr_keeps_float64_digits_at_complex64_input(rng, given_covariance):
    """MVDR's covariance and solve run at complex128 whatever the input's
    type: on a 2-mic mixture where one source is 40 dB below the other
    (covariance condition numbers of 1e5-1e6), complex64 input stays within
    1e-4 of the complex128 run, where complex64 algebra lost 1e-3 to 1e-2."""
    a = np.exp(2j * np.pi * rng.rand(17, 2, 2)) / np.sqrt(2)
    s = (rng.randn(2, 17, 48) + 1j * rng.randn(2, 17, 48)) * np.array([1.0, 1e-2])[:, None, None]
    X = np.einsum("fcs,sft->cft", a, s) + 1e-3 * (rng.randn(2, 17, 48) + 1j * rng.randn(2, 17, 48))
    Xb = X.transpose(1, 0, 2)
    call = {"covariance": Xb @ Xb.transpose(0, 2, 1).conj() / 48} if given_covariance else {}
    expected = to_np(port.MVDRBeamformer(steering_vector=a, device="cpu")(X, **call))
    Y = port.MVDRBeamformer(steering_vector=a, device="cpu")(X.astype(np.complex64), **call)
    assert Y.dtype == torch.complex64
    assert np.abs(to_np(Y) - expected).max() / np.abs(expected).max() <= 1e-4


def test_beamformer_raises():
    X = np.zeros((2, 3, 4), dtype=complex)
    with pytest.raises(ValueError, match="steering"):
        port.DelaySumBeamformer(device="cpu")(X)
    with pytest.raises(ValueError, match="steering"):
        port.MVDRBeamformer(device="cpu")(X)
    with pytest.raises(ValueError, match="covariance"):
        port.MaxSNRBeamformer(device="cpu")(X, signal_covariance=np.zeros((3, 2, 2)))


@pytest.mark.parametrize("n_channels", [2, 3])
def test_prox_matches_jax_trajectory(rng, n_channels):
    X = make_mixture(rng, n_channels=n_channels, n_bins=17, n_frames=40)
    kwargs = {"step": 0.7, "regularizer": 0.8, "step_prox_logdet": 2.0, "step_prox_penalty": 0.5}
    ref = jax_models.ProxLaplaceIVA(**kwargs)
    Y_ref = np.asarray(ref(X, iteration=ITERATIONS))
    ours = port.ProxLaplaceIVA(device="cpu", **kwargs)
    Y = ours(X, iteration=ITERATIONS)
    assert len(ours.loss) == ITERATIONS + 1
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(to_np(ours.demix_filter), np.asarray(ref.demix_filter), atol=1e-8)
    np.testing.assert_allclose(to_np(ours.dual), np.asarray(ref.dual), atol=1e-8)
    np.testing.assert_allclose(to_np(Y), Y_ref, atol=1e-8)


def test_prox_logdet_shrinks_singular_values(rng):
    """The closed form at C = 2 is the SVD shrinkage, for an ill-conditioned
    W too (singular values 3.2 and 3e-3)."""
    W = rng.randn(6, 2, 2) + 1j * rng.randn(6, 2, 2)
    W[0] = [[1, 2], [1, 2.01]]
    W[1] = np.diag([3.0, 0.5])  # the degenerate-eigenvector branch
    solver = port.ProxLaplaceIVA(device="cpu")
    W = torch.as_tensor(W)
    U, sigma, Vh = torch.linalg.svd(W)
    expected = (U * ((sigma + torch.sqrt(sigma**2 + 4 * 2.0)) / 2).to(U.dtype)[:, None, :]) @ Vh
    np.testing.assert_allclose(to_np(solver.prox_logdet(W, mu=2.0)), to_np(expected), atol=1e-10)


def test_prox_warm_start_and_checkpoint(rng, tmp_path):
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=40)
    full = port.ProxLaplaceIVA(step=0.5, device="cpu")
    Y_full = full(X, iteration=10)
    half = port.ProxLaplaceIVA(step=0.5, device="cpu")
    half(X, iteration=5)
    half.save_state(tmp_path / "prox.npz")
    state = half.load_state(tmp_path / "prox.npz")
    assert set(state) == {"demix_filter", "estimation", "dual"}
    Y = half(X, iteration=5, **state)
    np.testing.assert_allclose(half.loss[:6] + half.loss[7:], full.loss, rtol=1e-10)
    np.testing.assert_allclose(to_np(Y), to_np(Y_full), atol=1e-10)


def test_prox_resumes_a_jax_checkpoint(rng, tmp_path):
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=40)
    ref = jax_models.ProxLaplaceIVA(step=0.5)
    ref(X, iteration=4)
    ref.save_state(tmp_path / "jax_prox.npz")
    kwargs = state_from_jax(tmp_path / "jax_prox.npz", device="cpu")
    assert kwargs["dual"].shape == (17, 2, 40)
    Y_ref = np.asarray(ref(X, iteration=4, **ref.load_state(tmp_path / "jax_prox.npz")))
    ours = port.ProxLaplaceIVA(step=0.5, device="cpu")
    Y = ours(X, iteration=4, **kwargs)
    np.testing.assert_allclose(ours.loss, ref.loss[5:], rtol=1e-9)
    np.testing.assert_allclose(to_np(Y), Y_ref, atol=1e-8)


def test_prox_calls_no_callback_on_init(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=24)
    seen, seen_ref = [], []
    port.ProxLaplaceIVA(callbacks=lambda s: seen.append(to_np(s.estimation)), device="cpu")(X, iteration=3)
    jax_models.ProxLaplaceIVA(callbacks=lambda s: seen_ref.append(np.asarray(s.estimation)))(X, iteration=3)
    assert len(seen) == len(seen_ref) == 3
    for a, b in zip(seen, seen_ref):
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_sparse_prox_raises():
    with pytest.raises(NotImplementedError, match="coming soon"):
        port.SparseProxIVA()

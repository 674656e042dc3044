"""The port's harness (``utils``: metrics, synthesis, audio, callbacks)
against the JAX package on the CPU at float64: SI-SDR and PIT at 1e-9 dB,
``bss_eval_sources`` at 1e-6 dB on noisy estimates (SDR under 60 dB) with 2
and 3 sources at 64 and 512 taps, the degenerate cases of
``tests/test_utils_harness.py`` held to its thresholds and permutation,
synthesis at 1e-12, the callbacks' histories at 1e-6 dB with one entry per
iteration, and the ``utils`` export list."""

import os
import warnings

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu.utils as jax_utils
import audio_source_separation_tpu.utils.metrics as jax_metrics
import audio_source_separation_tpu.utils.synthesis as jax_synthesis
import audio_source_separation_tpu_torch as port
import audio_source_separation_tpu_torch.utils as port_utils
import audio_source_separation_tpu_torch.utils.metrics as port_metrics
import audio_source_separation_tpu_torch.utils.synthesis as port_synthesis
from audio_source_separation_tpu.transform import stft as jax_stft

from _torch_port import to_np

CPU = {"device": "cpu"}


def test_utils_exports_match_jax():
    assert set(port_utils.__all__) == set(jax_utils.__all__) | {"state_from_jax"}
    assert all(callable(getattr(port_utils, name)) for name in port_utils.__all__)
    assert port.utils is port_utils


def _noisy(seed, n_src, n_samples=4000, noise=0.3, leak=0.2):
    """References and estimates: a permutation of the references with
    leakage and noise, so SDR stays well under 60 dB."""
    rng = np.random.RandomState(seed)
    refs = rng.randn(n_src, n_samples)
    perm = np.roll(np.arange(n_src), 1)
    ests = refs[perm] + leak * refs + noise * rng.randn(n_src, n_samples)
    return refs, ests


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_src", [2, 3])
def test_si_sdr_family_matches_jax(n_src):
    refs, ests = _noisy(1, n_src)
    np.testing.assert_allclose(
        to_np(port_utils.si_sdr(ests, refs, **CPU)), np.asarray(jax_utils.si_sdr(ests, refs)), rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(
        to_np(port_utils.pairwise_si_sdr(ests, refs, **CPU)),
        np.asarray(jax_utils.pairwise_si_sdr(ests, refs)), rtol=0, atol=1e-9,
    )
    ours, theirs = port_utils.pit_si_sdr(ests, refs, **CPU), jax_utils.pit_si_sdr(ests, refs)
    assert isinstance(ours[0], float) and ours[1] == theirs[1]
    assert abs(ours[0] - theirs[0]) <= 1e-9
    mix = refs.sum(axis=0)
    ours = port_utils.si_sdr_improvement(torch.as_tensor(ests), mix, refs)
    assert isinstance(ours, float) and abs(ours - jax_utils.si_sdr_improvement(ests, mix, refs)) <= 1e-9


@pytest.mark.parametrize("filter_length", [64, 512])
@pytest.mark.parametrize("n_src", [2, 3])
def test_bss_eval_sources_matches_jax(n_src, filter_length):
    refs, ests = _noisy(2 + n_src, n_src)
    sdr, sir, sar, perm = port_utils.bss_eval_sources(refs, ests, filter_length=filter_length, **CPU)
    theirs = jax_utils.bss_eval_sources(refs, ests, filter_length=filter_length)
    assert (theirs[0] < 60).all()
    for ours, ref in zip((sdr, sir, sar), theirs[:3]):
        assert ours.dtype == torch.float64 and ours.device.type == "cpu"
        np.testing.assert_allclose(to_np(ours), ref, rtol=0, atol=1e-6)
    assert isinstance(perm, np.ndarray) and list(perm) == list(theirs[3])


def test_bss_eval_runs_at_float64_whatever_the_input():
    refs, ests = _noisy(6, 2)
    ours = port_utils.bss_eval_sources(torch.as_tensor(refs, dtype=torch.float32),
                                       torch.as_tensor(ests, dtype=torch.float32), filter_length=64)
    theirs = jax_utils.bss_eval_sources(refs.astype(np.float32), ests.astype(np.float32), filter_length=64)
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(to_np(a), b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("filter_length", [64, 512])
def test_bss_eval_improvement_matches_jax(filter_length):
    refs, ests = _noisy(7, 2)
    mix = refs.sum(axis=0)
    ours = port_utils.bss_eval_improvement(ests, mix, refs, filter_length=filter_length, **CPU)
    assert isinstance(ours, float)
    assert abs(ours - jax_utils.bss_eval_improvement(ests, mix, refs, filter_length=filter_length)) <= 1e-6


@pytest.mark.parametrize("L,which", [(6, (0, 1)), (6, (1,)), (1, (0,)), (1, (0, 1))])
def test_fir_projection_matches_jax_and_the_naive_lstsq(L, which):
    """The FFT block-Toeplitz projection equals JAX's and the explicit
    shift-matrix least squares (the BSS Eval definition), ``L = 1`` (one
    lag) included."""
    rng = np.random.RandomState(8)
    n = 257
    refs, est = rng.randn(2, n), rng.randn(n)
    ours = to_np(port_metrics._fir_projections(torch.as_tensor(refs), torch.as_tensor(est), L, which))
    np.testing.assert_allclose(ours, jax_metrics._fir_projections(refs, est, L, which), atol=1e-10)
    columns = []
    for j in which:
        for a in range(L):
            col = np.zeros(n + L - 1)
            col[a : a + n] = refs[j]
            columns.append(col)
    A = np.stack(columns, axis=1)
    naive, *_ = np.linalg.lstsq(A, np.concatenate([est, np.zeros(L - 1)]), rcond=None)
    np.testing.assert_allclose(ours, A @ naive, atol=1e-8)


def test_bss_eval_fft_size_is_the_next_power_of_two():
    assert port_metrics._fft_size(958_464 + 511) == 1 << 20
    assert port_metrics._fft_size(4096) == 4096 and port_metrics._fft_size(4097) == 8192


# the degenerate cases of tests/test_utils_harness.py: rounding noise sets
# the dB values, so the thresholds and the permutation are held
def test_bss_eval_exact_permutation_and_noise():
    rng = np.random.RandomState(111)
    refs = rng.randn(2, 2000)
    sdr, sir, sar, perm = port_utils.bss_eval_sources(refs, refs[::-1].copy(), filter_length=8, **CPU)
    _, _, _, perm_jax = jax_utils.bss_eval_sources(refs, refs[::-1], filter_length=8)
    assert (to_np(sdr) > 80).all() and list(perm) == [1, 0] == list(perm_jax)
    ests = refs + 0.1 * rng.randn(2, 2000)
    sdr, sir, sar, perm = port_utils.bss_eval_sources(refs, ests, filter_length=8, **CPU)
    assert (to_np(sdr) > 10).all() and (to_np(sir) >= to_np(sdr) - 1).all()


def test_bss_eval_filter_invariance():
    rng = np.random.RandomState(111)
    refs = rng.randn(2, 4000)
    h = rng.randn(5)
    filtered = np.stack([np.convolve(refs[0], h)[:4000], np.convolve(refs[1], h[::-1])[:4000]])
    sdr, sir, sar, perm = port_utils.bss_eval_sources(refs, filtered, filter_length=16, **CPU)
    assert (to_np(sdr) > 25).all() and (to_np(sir) > 40).all() and list(perm) == [0, 1]


def test_si_sdr_degenerate_cases():
    rng = np.random.RandomState(111)
    t = rng.randn(1000)
    assert abs(float(port_utils.si_sdr(3.0 * t, t, **CPU)) - 160) <= 40
    assert 15 < float(port_utils.si_sdr(t + 0.1 * rng.randn(1000), t, **CPU)) < 25
    a, b = rng.randn(500), rng.randn(500)
    value, perm = port_utils.pit_si_sdr(np.stack([b + 0.01 * rng.randn(500), a + 0.01 * rng.randn(500)]),
                                        np.stack([a, b]), **CPU)
    assert perm == (1, 0) and value > 30


def test_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    refs, ests = _noisy(9, 2, n_samples=100)
    for call in (
        lambda: port_utils.si_sdr(ests, refs),
        lambda: port_utils.pit_si_sdr(ests, refs),
        lambda: port_utils.bss_eval_sources(refs, ests, filter_length=8),
        lambda: port_utils.convolutive_mixture(refs, np.ones((2, 2, 3))),
        lambda: port_utils.synthetic_room_impulse_responses(2, 2),
        lambda: port_synthesis.mird_geometry_rirs(45),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# --------------------------------------------------------------------------- #
# synthesis and audio
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("taps", [32, 64])
def test_synthesis_matches_jax(taps):
    rng = np.random.RandomState(10)
    sources = rng.randn(2, 4000)
    rirs = port_utils.synthetic_room_impulse_responses(2, 3, taps=taps, seed=5, **CPU)
    rirs_jax = jax_utils.synthetic_room_impulse_responses(2, 3, taps=taps, seed=5)
    np.testing.assert_allclose(to_np(rirs), rirs_jax, rtol=0, atol=1e-12)
    mixture, images = port_utils.convolutive_mixture(sources, rirs)
    mixture_jax, images_jax = jax_utils.convolutive_mixture(sources, rirs_jax)
    assert mixture.dtype == torch.float64 and mixture.shape == (3, 4000) and images.shape == (2, 3, 4000)
    np.testing.assert_allclose(to_np(mixture), mixture_jax, rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_np(images), images_jax, rtol=0, atol=1e-12)
    short, _ = port_utils.convolutive_mixture(sources, rirs, n_samples=3000)
    np.testing.assert_allclose(to_np(short), mixture_jax[:, :3000], rtol=0, atol=1e-12)


@pytest.mark.parametrize("degree,intervals", [(0, "3-3-3-8-3-3-3"), (45, "8-8-8-8-8-8-8"), (315, "3-3-3-8-3-3-3")])
def test_mird_geometry_rirs_match_jax(degree, intervals):
    assert port_synthesis.MIRD_DEGREES == jax_synthesis.MIRD_DEGREES
    ours = port_synthesis.mird_geometry_rirs(degree, mic_intervals=intervals, samples=1600, **CPU)
    theirs = jax_synthesis.mird_geometry_rirs(degree, mic_intervals=intervals, samples=1600)
    assert ours.shape == (1600, 8)
    np.testing.assert_allclose(to_np(ours), theirs, rtol=0, atol=1e-12)


def test_wav_round_trip_and_companding(tmp_path):
    rng = np.random.RandomState(11)
    signal = np.clip(rng.randn(2, 500) * 0.3, -1, 1)
    port_utils.write_wav(tmp_path / "port.wav", torch.as_tensor(signal), 16000, channel_last=False)
    jax_utils.write_wav(tmp_path / "jax.wav", signal, 16000, channel_last=False)
    ours, sr = port_utils.read_wav(tmp_path / "port.wav")
    theirs, _ = jax_utils.read_wav(tmp_path / "jax.wav")
    assert sr == 16000 and isinstance(ours, np.ndarray)
    np.testing.assert_array_equal(ours, theirs)
    y = port_utils.mu_law_compand(torch.as_tensor(signal))
    assert isinstance(y, torch.Tensor)
    np.testing.assert_allclose(to_np(y), jax_utils.mu_law_compand(signal), atol=1e-12)
    np.testing.assert_allclose(to_np(port_utils.inv_mu_law_compand(y)), signal, atol=1e-12)
    np.testing.assert_allclose(port_utils.inv_mu_law_compand(port_utils.mu_law_compand(signal)), signal, atol=1e-12)
    with pytest.raises(ValueError):
        port_utils.write_wav(tmp_path / "bad.wav", np.zeros((1, 1, 1)), 16000)


# --------------------------------------------------------------------------- #
# callbacks
# --------------------------------------------------------------------------- #
FFT, HOP, N_SAMPLES, ITERATIONS = 256, 128, 4000, 3


def _images():
    rng = np.random.RandomState(12)
    t = np.arange(N_SAMPLES) / 16000
    env = np.stack([0.5 * (1 + np.sign(np.sin(2 * np.pi * f * t + p))) for f, p in ((3, 0), (5, 0.7))])
    sources = env * rng.randn(2, N_SAMPLES)
    mixture, images = jax_utils.convolutive_mixture(sources, jax_utils.synthetic_room_impulse_responses(2, 2, taps=16))
    return mixture, images[:, 0]


# every solver family the callbacks serve, each publishing ``estimation``
# on every call (the K2 path at C = 2 forms it only when callbacks are set;
# the MNMF solvers publish their separated output, which the JAX package's
# do not)
CALLBACK_SOLVERS = {
    "laplace_ip": ("AuxLaplaceIVA", {}),
    "laplace_iss": ("AuxLaplaceIVA", {"algorithm_spatial": "ISS"}),
    "laplace_ip2": ("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}),
    "gauss_ip": ("AuxGaussIVA", {}),
    "gauss_ilrma": ("GaussILRMA", {"n_basis": 2}),
    "fast_mnmf": ("FastMultichannelISNMF", {"n_basis": 2}),
    "sawada": ("MultichannelISNMF", {"n_basis": 2}),
    "prox": ("ProxLaplaceIVA", {}),
    "natural_grad_fdica": ("NaturalGradLaplaceFDICA", {}),
    "ipsdta_kondo": ("GaussIPSDTA", {"n_basis": 2, "n_blocks": 64}),  # the compact route
}  # fmt: skip
PUBLISHES_NO_ESTIMATION_IN_JAX = {"fast_mnmf", "sawada"}


def _callbacks(lib, images, length):
    return [
        lib.SDRImprovementCallback(images, fft_size=FFT, hop_size=HOP, length=length),
        lib.BSSEvalCallback(images, fft_size=FFT, hop_size=HOP, length=length, filter_length=32, stride=2),
    ]


def _jax_histories(name, X, images, calls):
    """The JAX callbacks' histories; for a solver that publishes no
    estimates during its call, the callbacks fed after a call of each
    iteration count (the output then published)."""
    cls, kw = CALLBACK_SOLVERS[name]
    theirs = _callbacks(jax_utils, images, N_SAMPLES)
    if name not in PUBLISHES_NO_ESTIMATION_IN_JAX:
        np.random.seed(111)
        getattr(jax_models, cls)(callbacks=theirs, **kw)(X, iteration=ITERATIONS)
        return theirs
    for k in range(ITERATIONS + 1 - calls, ITERATIONS + 1):
        np.random.seed(111)
        solver = getattr(jax_models, cls)(**kw)
        solver(X, iteration=k)
        for callback in theirs:
            callback(solver)
    return theirs


@pytest.mark.parametrize("name", sorted(CALLBACK_SOLVERS))
def test_callback_histories_match_jax(name):
    warnings.simplefilter("ignore")
    mixture, images = _images()
    X = np.asarray(jax_stft(mixture, fft_size=FFT, hop_size=HOP))
    cls, kw = CALLBACK_SOLVERS[name]
    ours = _callbacks(port_utils, images, N_SAMPLES)
    np.random.seed(111)
    solver = getattr(port, cls)(callbacks=ours, device="cpu", **kw)
    solver(X, iteration=ITERATIONS)
    calls = ITERATIONS + (1 if solver.callback_on_init else 0)
    theirs = _jax_histories(name, X, images, calls)

    assert len(ours[0].history) == calls == len(theirs[0].history)
    assert all(isinstance(v, float) for v in ours[0].history)
    # an estimate orthogonal to its target (Prox's first, whose second
    # source sits at -60 dB SI-SDR) is rounding noise: JAX's own metrics
    # move by 1e-4 dB there when their input moves by 1e-14, so an entry
    # below -20 dB is held to that threshold
    orthogonal = [ref < -20 for ref in theirs[0].history]
    for value, ref, degenerate in zip(ours[0].history, theirs[0].history, orthogonal):
        assert (value < -20) if degenerate else abs(value - ref) <= 1e-6
    assert len(ours[1].history) == (calls + 1) // 2 == len(theirs[1].history)
    for k, (triple, ref) in enumerate(zip(ours[1].history, theirs[1].history)):
        assert all(a.dtype == torch.float64 and torch.isfinite(a).all() for a in triple)
        sdr, sir, sar = map(to_np, triple)
        if orthogonal[2 * k]:
            continue
        np.testing.assert_allclose(sir, ref[1], rtol=0, atol=1e-6)
        # an estimate inside the span of the references' filters (the init's
        # filtered mixture) has its artefact energy at rounding noise, SAR
        # near 200 dB, where SDR and SAR are rounding noise as well: that
        # entry is held to the threshold
        in_span = ref[2] > 60
        np.testing.assert_array_equal(sar > 60, in_span)
        if not in_span.any():
            np.testing.assert_allclose(sdr, ref[0], rtol=0, atol=1e-6)
            np.testing.assert_allclose(sar, ref[2], rtol=0, atol=1e-6)
            np.testing.assert_allclose(ours[1].sdri_history[k], theirs[1].sdri_history[k], rtol=0, atol=1e-6)


def test_snapshots_and_loss_logger_match_jax(tmp_path):
    mixture, images = _images()
    X = np.asarray(jax_stft(mixture, fft_size=FFT, hop_size=HOP))
    printed = {"jax": [], "port": []}
    for lib, make, key in ((jax_utils, jax_models.GaussILRMA, "jax"), (port_utils, port.GaussILRMA, "port")):
        np.random.seed(111)
        callbacks = [lib.StateSnapshotCallback(str(tmp_path / key)), lib.LossLogger(stride=2, printer=printed[key].append)]
        kw = {"device": "cpu"} if key == "port" else {}
        make(n_basis=2, callbacks=callbacks, **kw)(X, iteration=ITERATIONS)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and len(files) == ITERATIONS + 1
    for name in files:
        with np.load(tmp_path / "port" / name) as ours, np.load(tmp_path / "jax" / name) as theirs:
            assert sorted(ours.files) == sorted(theirs.files) == ["activation", "basis"]
            for field in ours.files:
                np.testing.assert_allclose(ours[field], theirs[field], rtol=1e-9)
    assert len(printed["port"]) == len(printed["jax"]) == 2
    assert [line.split(":")[0] for line in printed["port"]] == [line.split(":")[0] for line in printed["jax"]]

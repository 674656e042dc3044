"""The port's AuxLaplaceIVA-IP against the JAX package on the CPU (float64):
whole loss trajectories, final filters and outputs, callbacks, warm starts,
resuming a JAX checkpoint, and separation quality; which kernel each update
calls (the rest of the IVA family's parity is in
``test_torch_iva_family.py``)."""

import numpy as np
import pytest
import torch

from audio_source_separation_tpu.models import AuxLaplaceIVA as JaxAuxLaplaceIVA
from audio_source_separation_tpu.transform import stft as j_stft
from audio_source_separation_tpu_torch import (
    AuxGaussIVA,
    AuxLaplaceIVA,
    SparseAuxIVA,
    istft,
    state_from_jax,
    stft,
)
from audio_source_separation_tpu_torch.ops.cov_kernel import weighted_covariance_planes
from audio_source_separation_tpu_torch.ops.fused_ip import fused_auxiva_ip_iter

from conftest import make_mixture, synth_convolutive_mixture


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_channels,guard", [(2, "one_norm"), (3, "one_norm"), (2, "none")])
def test_matches_jax_trajectory(rng, n_channels, guard):
    """C = 2 runs the K2 plain path, C = 3 and guard='none' the K1 plain path."""
    X = make_mixture(rng, n_channels=n_channels, n_bins=17, n_frames=40)
    ref = JaxAuxLaplaceIVA(algorithm_spatial="IP", guard=guard)
    Y_ref = np.asarray(ref(X, iteration=10))
    ours = AuxLaplaceIVA(algorithm_spatial="IP", guard=guard, device="cpu")
    Y = ours(X, iteration=10)
    assert len(ours.loss) == 11
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(_np(ours.demix_filter), np.asarray(ref.demix_filter), atol=1e-8)
    np.testing.assert_allclose(_np(Y), Y_ref, atol=1e-8)
    assert np.all(np.diff(ours.loss) <= 1e-9 * np.abs(ours.loss[:-1]))


def test_matches_jax_past_6144_frames(rng):
    """C = 2 at T = 6200 frames, past the 6144 that K2 once capped: the
    entry takes any length, and the trajectory matches JAX."""
    X = make_mixture(rng, n_channels=2, n_bins=5, n_frames=6200)
    ref = JaxAuxLaplaceIVA(algorithm_spatial="IP")
    Y_ref = np.asarray(ref(X, iteration=3))
    ours = AuxLaplaceIVA(algorithm_spatial="IP", device="cpu")
    Y = ours(X, iteration=3)
    assert len(ours.loss) == 4
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(_np(Y), Y_ref, atol=1e-8)


@pytest.mark.parametrize(
    "solver,algorithm,n_channels,guard",
    [
        pytest.param(AuxLaplaceIVA, "IP", 2, "one_norm", id="2-one_norm"),
        pytest.param(AuxLaplaceIVA, "IP", 3, "one_norm", id="3-one_norm"),
        pytest.param(AuxLaplaceIVA, "IP", 2, "none", id="2-none"),
        pytest.param(AuxGaussIVA, "IP", 2, "one_norm", id="gauss-2-one_norm"),
        pytest.param(AuxGaussIVA, "IP", 3, "one_norm", id="gauss-3-one_norm"),
        pytest.param(AuxLaplaceIVA, "IP2", 2, "one_norm", id="ip2-2-one_norm"),
        pytest.param(AuxLaplaceIVA, "IP2", 3, "one_norm", id="ip2-3-one_norm"),
        pytest.param(AuxLaplaceIVA, "IP2", 4, "one_norm", id="ip2-4-one_norm"),
    ],
)
def test_update_dispatch(rng, monkeypatch, solver, algorithm, n_channels, guard):
    """IP at C = 2 with the one-norm guard calls K2 once per iteration, with
    the solver's contrast, and never K1; every other IP configuration, and
    IP2 (its pair's covariances), calls K1 at least once per iteration and
    never K2."""
    calls = {"k1": 0, "k2": 0}
    contrasts = set()
    import audio_source_separation_tpu_torch.models.iva as iva
    import audio_source_separation_tpu_torch.ops.covariance as cov

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            if name == "k2":
                contrasts.add(kwargs["contrast"])
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(cov, "weighted_covariance_planes", counted("k1", weighted_covariance_planes))
    monkeypatch.setattr(iva, "fused_auxiva_ip_iter", counted("k2", fused_auxiva_ip_iter))
    X = make_mixture(rng, n_channels=n_channels, n_bins=9, n_frames=16)
    solver(algorithm_spatial=algorithm, guard=guard, device="cpu", recordable_loss=False)(X, iteration=4)
    if algorithm == "IP" and n_channels == 2 and guard == "one_norm":
        assert calls == {"k1": 0, "k2": 4}
        assert contrasts == {solver.contrast}
    else:
        assert calls["k2"] == 0 and calls["k1"] >= 4


def test_callbacks_see_synced_filters(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16)
    seen, seen_ref = [], []
    ours = AuxLaplaceIVA(callbacks=lambda s: seen.append(_np(s.demix_filter).copy()), device="cpu")
    ours(X, iteration=3)
    ref = JaxAuxLaplaceIVA(callbacks=lambda s: seen_ref.append(np.asarray(s.demix_filter).copy()))
    ref(X, iteration=3)
    assert len(seen) == 4  # init + 3 iterations
    for a, b in zip(seen, seen_ref):
        np.testing.assert_allclose(a, b, atol=1e-10)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)


def test_warm_start_two_plus_one(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16)
    s1 = AuxLaplaceIVA(recordable_loss=False, device="cpu")
    s1(X, iteration=2)
    s2 = AuxLaplaceIVA(recordable_loss=False, device="cpu")
    s2(X, iteration=1, demix_filter=s1.demix_filter)
    s3 = AuxLaplaceIVA(recordable_loss=False, device="cpu")
    s3(X, iteration=3)
    np.testing.assert_allclose(_np(s2.demix_filter), _np(s3.demix_filter), atol=1e-10)


@pytest.mark.parametrize("n_channels", [2, 3])
def test_resume_jax_checkpoint(rng, tmp_path, n_channels):
    """A JAX save_state .npz resumes in the port onto the JAX 3+3 trajectory."""
    X = make_mixture(rng, n_channels=n_channels, n_bins=11, n_frames=24)
    jax_solver = JaxAuxLaplaceIVA()
    jax_solver(X, iteration=3)
    path = tmp_path / "state.npz"
    jax_solver.save_state(path)
    jax_solver(X, iteration=3, **JaxAuxLaplaceIVA.load_state(path))

    ours = AuxLaplaceIVA(device="cpu")
    ours(X, iteration=3, **state_from_jax(path, device="cpu"))
    np.testing.assert_allclose(ours.loss, jax_solver.loss[4:], rtol=1e-9)
    np.testing.assert_allclose(_np(ours.demix_filter), np.asarray(jax_solver.demix_filter), atol=1e-8)

    components = np.transpose(np.asarray(jax_solver.demix_filter), (1, 2, 0))
    kwargs = state_from_jax({"demix_components": components}, device="cpu")
    np.testing.assert_array_equal(_np(kwargs["demix_filter"]), np.asarray(jax_solver.demix_filter))


def test_port_save_state_round_trip(rng, tmp_path):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16)
    s1 = AuxLaplaceIVA(device="cpu")
    s1(X, iteration=2)
    s1.save_state(tmp_path / "port.npz")
    s1(X, iteration=1, **AuxLaplaceIVA.load_state(tmp_path / "port.npz"))
    s3 = AuxLaplaceIVA(device="cpu")
    s3(X, iteration=3)
    np.testing.assert_allclose(s1.loss[-1], s3.loss[-1], rtol=1e-10)


def test_loss_concatenates_across_calls(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16)
    solver = AuxLaplaceIVA(device="cpu")
    solver(X, iteration=2)
    solver(X, iteration=3)
    assert len(solver.loss) == 3 + 4
    ref = JaxAuxLaplaceIVA()
    ref(X, iteration=2)
    ref(X, iteration=3)
    np.testing.assert_allclose(solver.loss, ref.loss, rtol=1e-9)


def test_extra_kwargs_become_attributes(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16)
    marks = []
    solver = AuxLaplaceIVA(callbacks=lambda s: s.marks.append(1), recordable_loss=False, device="cpu")
    solver(X, iteration=2, marks=marks)
    assert solver.marks is marks and len(marks) == 3


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AuxLaplaceIVA()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stft(np.zeros((2, 1024)), fft_size=256)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        istft(np.zeros((2, 129, 9), dtype=complex), fft_size=256)


def test_unported_configurations_raise(rng):
    """What the JAX package refuses, the port refuses: IPA (``ValueError``),
    AuxGaussIVA's IP2 and the SparseAuxIVA stub (``NotImplementedError``),
    and unknown updates or guards (``ValueError``)."""
    with pytest.raises(ValueError):
        AuxLaplaceIVA(algorithm_spatial="IPA", device="cpu")(make_mixture(rng), iteration=1)
    for algorithm in ("IP2", "pairwise"):
        with pytest.raises(NotImplementedError, match="In progress"):
            AuxGaussIVA(algorithm_spatial=algorithm, device="cpu")(make_mixture(rng), iteration=1)
    with pytest.raises(NotImplementedError, match="in progress"):
        SparseAuxIVA(device="cpu")
    with pytest.raises(ValueError):
        AuxLaplaceIVA(algorithm_spatial="IP3", device="cpu")
    with pytest.raises(ValueError):
        AuxLaplaceIVA(guard="two_norm", device="cpu")


def _si_sdr(estimate, target):
    alpha = np.sum(estimate * target) / np.sum(target**2)
    projection = alpha * target
    noise = estimate - projection
    return 10 * np.log10(np.sum(projection**2) / np.sum(noise**2))


def _best_pairing_sisdr(estimates, sources):
    a = np.mean([_si_sdr(estimates[0], sources[0]), _si_sdr(estimates[1], sources[1])])
    b = np.mean([_si_sdr(estimates[0], sources[1]), _si_sdr(estimates[1], sources[0])])
    return max(a, b)


def test_separates_convolutive_mixture(rng):
    """The bar of test_iva.py::test_auxiva_separates_convolutive_mixture."""
    mixture, sources = synth_convolutive_mixture(rng, n_sources=2, n_samples=16000)
    X = stft(mixture, fft_size=512, hop_size=256, device="cpu")
    np.testing.assert_allclose(_np(X), np.asarray(j_stft(mixture, fft_size=512, hop_size=256)), atol=1e-12)
    Y = AuxLaplaceIVA(recordable_loss=False, device="cpu")(X, iteration=25)
    y = _np(istft(Y, fft_size=512, hop_size=256, length=mixture.shape[-1], device="cpu"))
    before = _best_pairing_sisdr(mixture, sources)
    after = _best_pairing_sisdr(y, sources)
    assert after > before + 5.0, (before, after)


def test_complex64_input_stays_complex64_on_cpu(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16, dtype=np.complex64)
    Y = AuxLaplaceIVA(device="cpu")(X, iteration=2)
    assert Y.dtype == torch.complex64 and torch.isfinite(Y).all()

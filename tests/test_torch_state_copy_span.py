"""The copies of a solver's drawn or warm-start state from the host
(``runtime/solver.py::state_tensor``), on the CPU: each is a
``solve.state_copy_in`` span inside ``solve.init`` and counts in
``host_copies`` / ``host_copy_bytes``; state already on the device is
neither spanned nor counted, and a call that takes no host state (AuxIVA's)
records no such span."""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.runtime import profiling, spanlog

FFT, HOP = 256, 128
ITERATION = 3
N_BASIS = 2


@pytest.fixture(autouse=True)
def empty_log():
    spanlog.clear()
    yield
    spanlog.clear()


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _spectrogram(seed=0, n=4000):
    x = np.random.default_rng(seed).standard_normal((2, n))
    return port.stft(x, FFT, HOP, device="cpu")  # complex128: the state runs at float64


def _solve_spans():
    spans = profiling.spans()
    (solve,) = [s for s in spans if s.name == "solve"]
    (init,) = [s for s in spans if s.name == "solve.init"]
    copies = [s for s in spans if s.name == "solve.state_copy_in"]
    return solve, init, copies


def _fastmnmf():
    return port.FastMultichannelISNMF(n_basis=N_BASIS, device="cpu")


def test_fastmnmf_drawn_state_is_copied_in_inside_init():
    X = _spectrogram()
    C, F, T = X.shape
    before = dict(profiling.counters)
    with _profiler():
        _fastmnmf()(X, iteration=ITERATION)
    solve, init, copies = _solve_spans()
    # the gains, the basis and the activation; the identity diagonaliser is
    # made on the device
    assert len(copies) == 3
    assert all(s.parent == init.id and init.start_ns <= s.start_ns <= s.end_ns <= init.end_ns for s in copies)
    state_bytes = 8 * (C * F * C + C * F * N_BASIS + C * N_BASIS * T)
    losses_bytes = 8 * (ITERATION + 1)
    assert solve.attrs["host_copies"] == 3 + 1
    assert solve.attrs["host_copy_bytes"] == state_bytes + losses_bytes
    assert profiling.counters["host_copies"] - before["host_copies"] == 4
    assert profiling.counters["host_copy_bytes"] - before["host_copy_bytes"] == state_bytes + losses_bytes


def test_state_already_on_the_device_is_not_counted():
    X = _spectrogram()
    C, F, T = X.shape
    rng = np.random.default_rng(1)
    warm = {
        "basis": torch.as_tensor(rng.random((C, F, N_BASIS))),
        "activation": torch.as_tensor(rng.random((C, N_BASIS, T))),
        "spatial_covariance": torch.ones((C, F, C), dtype=torch.float64),
    }
    with _profiler():
        _fastmnmf()(X, iteration=ITERATION, **warm)
    solve, _, copies = _solve_spans()
    assert copies == []
    assert solve.attrs["host_copies"] == 1  # the losses alone


def test_the_counters_count_without_a_profiler():
    X = _spectrogram()
    before = profiling.counters["host_copies"]
    _fastmnmf()(X, iteration=ITERATION)
    assert profiling.counters["host_copies"] - before == 4
    assert profiling.spans() == []


def test_ilrma_shares_the_helper():
    X = _spectrogram()
    with _profiler():
        port.GaussILRMA(n_basis=N_BASIS, device="cpu")(X, iteration=ITERATION)
    solve, init, copies = _solve_spans()
    assert len(copies) == 2  # the basis and the activation
    assert all(s.parent == init.id for s in copies)
    assert solve.attrs["host_copies"] == 2 + 1


@pytest.mark.parametrize("emulate", [False, True], ids=["eager", "captured_emulated"])
def test_auxiva_takes_no_host_state(emulate):
    X = _spectrogram()
    solver = port.AuxLaplaceIVA(algorithm_spatial="IP", device="cpu")
    solver._emulate_graph = emulate
    with _profiler():
        solver(X, iteration=ITERATION)
    solve, _, copies = _solve_spans()
    assert copies == []
    assert solve.attrs["host_copies"] == 1  # the losses' one transfer, as before
    assert solve.attrs["host_copy_bytes"] == 8 * (ITERATION + 1)

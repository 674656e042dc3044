"""Kernel K5's CPU side (``ops/mnmf_mu.py``): FastMNMF's MU sweeps with the
model formed inside the contractions.

Its plain version gives the bits of the sweeps, K1's weights and the NLL's
fit as ``models/mnmf.py`` wrote them before K5 (restated below, frozen), at
float64 and float32, C = 2, 3, 4, K = 1, 10 and the largest K the kernel
takes, odd frame counts; the wrapper runs the plain version on the CPU,
with ``whole`` applied to the statistics; FastMNMF takes the wrapper within
the kernel's limits and the plain version past them; one FastMNMF step
against the JAX package at float64; the wrapper's argument checks raise
before anything is built; ``k5_cost`` and its charge; and the
``k5_launches`` counter across a captured loop (emulated).  The card's
tests are ``tests/test_torch_cuda_mnmf_mu.py``.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.models import mnmf as port_mnmf
from audio_source_separation_tpu_torch.ops import _build, mnmf_mu
from audio_source_separation_tpu_torch.ops.mnmf_mu import (
    ENTRIES,
    MAX_J,
    MAX_M,
    MAX_S,
    fastmnmf_mu,
    fastmnmf_mu_plain,
    k5_cost,
    takes,
)
from audio_source_separation_tpu_torch.runtime import profiling
from audio_source_separation_tpu_torch.runtime.cost_model import CostCounter
from audio_source_separation_tpu_torch.utils.flooring import EPS, floor_below

from _torch_port import assert_losses_match, to_np
from conftest import make_mixture

F, T = 11, 33
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _frozen_model_power(W, g, H):
    """``FastMultichannelISNMF._model_power`` as it stood before K5."""
    n_sources, n_bins, n_basis = W.shape
    Wg = torch.einsum("sfk,sfm->mfsk", W, g).reshape(g.shape[-1], n_bins, n_sources * n_basis)
    return torch.matmul(Wg, H.reshape(n_sources * n_basis, -1))


def _frozen_frame_statistics(x, W, g, H, eps):
    R = floor_below(_frozen_model_power(W, g, H), eps)
    return torch.einsum("mft,skt->mfsk", x / R**2, H), torch.einsum("mft,skt->mfsk", 1 / R, H)


def _frozen(entry, x, W, g, H, eps):
    """Each entry's result as ``_update_nmf``, ``_update_scm``,
    ``_update_diagonalizer`` and ``nll`` computed it before K5."""
    if entry == "weights":
        return 1.0 / floor_below(_frozen_model_power(W, g, H), eps)
    if entry == "fit":
        y_tilde = _frozen_model_power(W, g, H) + eps
        return torch.sum((x + eps) / y_tilde + torch.log(y_tilde))
    if entry == "basis":
        E_num, E_den = _frozen_frame_statistics(x, W, g, H, eps)
        num = torch.einsum("sfm,mfsk->sfk", g, E_num)
        den = floor_below(torch.einsum("sfm,mfsk->sfk", g, E_den), eps)
        return W * torch.sqrt(num / den)
    if entry == "gains":
        E_num, E_den = _frozen_frame_statistics(x, W, g, H, eps)
        A = torch.einsum("sfk,mfsk->sfm", W, E_num)
        B = floor_below(torch.einsum("sfk,mfsk->sfm", W, E_den), eps)
        return g * torch.sqrt(A / B)
    R = floor_below(_frozen_model_power(W, g, H), eps)
    Wg = torch.einsum("sfk,sfm->skmf", W, g)
    num = torch.einsum("mft,skmf->skt", x / R**2, Wg)
    den = torch.einsum("mft,skmf->skt", 1 / R, Wg)
    return H * torch.sqrt(num / floor_below(den, eps))


def _operands(M, S, K, dtype, seed=0, n_frames=T):
    """Powers over five decades and factors uniform in (0.05, 1), at
    ``dtype``; W is zero in bin 2, so that the model reaches the floor
    there."""
    rng = np.random.RandomState(seed)
    x = 10 ** (5 * rng.rand(M, F, n_frames) - 3)
    W, g, H = (0.05 + 0.95 * rng.rand(*shape) for shape in ((S, F, K), (S, F, M), (S, K, n_frames)))
    W[:, 2] = 0
    return [torch.as_tensor(a, dtype=dtype) for a in (x, W, g, H)]


@pytest.mark.parametrize("K", ["1", "10", "largest"])
@pytest.mark.parametrize("C", [2, 3, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_plain_version_gives_the_bits_of_the_sweeps_before_k5(dtype, C, K):
    """At S = C sources; the largest K the kernel takes is MAX_J // C, and
    K = 10 is past it at C = 3 and 4, where the wrapper raises.  The plain
    version is the code moved, so it is held bit for bit, tighter than
    1e-12 (float64) and 1e-6 (float32) would be."""
    largest = K == "largest"
    K = {"1": 1, "10": 10, "largest": MAX_J // C}[K]
    assert (takes(C, C, K) and not takes(C, C, K + 1)) if largest else takes(C, C, K) == (C * K <= MAX_J)
    ops = _operands(C, C, K, DTYPES[dtype], seed=C * 100 + K)
    for entry in ENTRIES:
        want = _frozen(entry, *ops, EPS)
        assert torch.equal(fastmnmf_mu_plain(entry, *ops, EPS), want), entry
        if takes(C, C, K):
            assert torch.equal(fastmnmf_mu(entry, *ops, EPS), want), entry  # the CPU route is the plain version
        else:
            with pytest.raises(ValueError):
                fastmnmf_mu(entry, *ops, EPS)


@pytest.mark.parametrize("entry", ["basis", "gains", "activation"])
def test_whole_makes_the_statistics_whole(entry):
    """``whole`` receives the entry's two partial sums and the update
    follows from what it returns, on both routes alike."""
    ops = _operands(2, 2, 4, torch.float64, seed=5)
    seen = []

    def doubled(sums):
        seen.append([tuple(s.shape) for s in sums])
        return [2 * s for s in sums]

    got = fastmnmf_mu(entry, *ops, EPS, whole=doubled)
    assert torch.equal(got, fastmnmf_mu_plain(entry, *ops, EPS, whole=doubled))
    stats = (2, 4, T) if entry == "activation" else (2, F, 2, 4)
    assert seen == [[stats, stats]] * 2
    # num / den is unchanged by doubling both but where den meets the floor
    torch.testing.assert_close(got, fastmnmf_mu_plain(entry, *ops, EPS), rtol=1e-12, atol=0)
    identity = fastmnmf_mu(entry, *ops, EPS, whole=lambda sums: list(sums))
    assert torch.equal(identity, fastmnmf_mu_plain(entry, *ops, EPS))


@pytest.mark.parametrize("entry", ["basis", "gains", "activation"])
def test_the_card_s_update_from_whole_statistics(entry):
    """The update the card takes after a mesh's all-reduce (its sums one
    term at a time, in the kernel's order) agrees with the plain version's
    einsum update."""
    x, W, g, H = _operands(3, 2, 4, torch.float64, seed=6)
    statistics, update = mnmf_mu._SWEEPS[entry]
    sums = statistics(x, W, g, H, EPS)
    got = mnmf_mu._ordered_update(entry, W, g, H, *sums, EPS)
    torch.testing.assert_close(got, update(W, g, H, *sums, EPS), rtol=1e-12, atol=0)


def test_the_kernels_limits():
    assert (MAX_M, MAX_S, MAX_J) == (4, 4, 24)
    assert takes(2, 2, 10) and takes(2, 2, 12) and takes(4, 4, 6) and takes(1, 1, 24)
    assert not takes(5, 2, 10) and not takes(2, 5, 1) and not takes(2, 2, 13) and not takes(3, 3, 10)
    assert not takes(0, 2, 10)


def _mixture(C, seed, n_frames=T):
    return torch.as_tensor(make_mixture(np.random.RandomState(seed), n_channels=C, n_bins=F, n_frames=n_frames))


@pytest.mark.parametrize(
    "C, n_basis, routed", [(2, 10, True), (4, 6, True), (3, 10, False), (5, 2, False)],
    ids=["C2-K10", "C4-largest-K", "past-S-K", "past-M"],
)
def test_fastmnmf_takes_the_wrapper_within_the_limits(monkeypatch, C, n_basis, routed):
    """Within the kernel's limits every entry goes through the wrapper (on
    the CPU its plain version, no build); past them through the plain
    version directly, the wrapper never called."""
    calls = {"wrapper": [], "plain": []}
    wrapper, plain = port_mnmf.fastmnmf_mu, port_mnmf.fastmnmf_mu_plain
    monkeypatch.setattr(port_mnmf, "fastmnmf_mu", lambda *a, **k: calls["wrapper"].append(a[0]) or wrapper(*a, **k))
    monkeypatch.setattr(port_mnmf, "fastmnmf_mu_plain", lambda *a, **k: calls["plain"].append(a[0]) or plain(*a, **k))
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built " + name))
    solver = port.FastMultichannelISNMF(n_basis=n_basis, device="cpu")
    np.random.seed(111)
    solver(_mixture(C, seed=C), iteration=2)
    # the initial loss, then each step's sweeps, K1's weights and its loss
    expected = ["fit"] + ["basis", "activation", "gains", "weights", "fit"] * 2
    assert calls["wrapper" if routed else "plain"] == expected
    assert calls["plain" if routed else "wrapper"] == []


def test_one_fastmnmf_step_against_the_jax_package():
    """One iteration from the seed-111 draws at float64: the two losses and
    the state as the JAX package's."""
    X = make_mixture(np.random.RandomState(25), n_channels=2, n_bins=F, n_frames=T)
    runs = []
    for package, kwargs in ((jax_models, {}), (port, {"device": "cpu"})):
        solver = package.FastMultichannelISNMF(n_basis=4, **kwargs)
        np.random.seed(111)
        runs.append((solver, solver(X, iteration=1)))
    (ref, Y_ref), (ours, Y) = runs
    assert_losses_match(ours.loss, ref.loss, rtol=1e-9)
    for field in ("diagonalizer", "spatial_covariance", "basis", "activation"):
        np.testing.assert_allclose(to_np(getattr(ours, field)), np.asarray(getattr(ref, field)), atol=1e-10)
    np.testing.assert_allclose(to_np(Y), np.asarray(Y_ref), atol=1e-10)


def _strided(t):
    return t.transpose(0, -1).contiguous().transpose(0, -1)


BAD = {
    "an unknown entry": lambda x, W, g, H: ("model", x, W, g, H),
    "a 2-D basis": lambda x, W, g, H: ("basis", x, W[0], g, H),
    "gains of other bins": lambda x, W, g, H: ("basis", x, W, g[:, 1:], H),
    "activations of other frames": lambda x, W, g, H: ("basis", x, W, g, H[:, :, 1:]),
    "bases past the limit": lambda x, W, g, H: ("basis", x, W.repeat(1, 1, 4), g, H.repeat(1, 4, 1)),
    "five channels": lambda x, W, g, H: ("basis", torch.cat([x, x, x[:1]]), W, torch.cat([g, g, g[:, :, :1]], 2), H),
    "five sources": lambda x, W, g, H: ("basis", x, torch.cat([W, W, W[:1]]), torch.cat([g, g, g[:1]]),
                                        torch.cat([H, H, H[:1]])),
    "a float64 basis": lambda x, W, g, H: ("basis", x, W.double(), g, H),
    "complex powers": lambda x, W, g, H: ("basis", x.to(torch.complex64), W, g, H),
    "half operands": lambda x, W, g, H: ("basis", x.half(), W.half(), g.half(), H.half()),
    "on the meta device": lambda x, W, g, H: ("basis", x, W, g, H.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_the_wrapper_raises_before_anything_is_built(monkeypatch, case):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built " + name))
    entry, *args = BAD[case](*_operands(2, 2, 4, torch.float32))
    with pytest.raises(ValueError):
        fastmnmf_mu(entry, *args, EPS)


def test_a_strided_operand_is_taken_on_the_cpu():
    """Contiguity is the card's demand only."""
    x, W, g, H = _operands(2, 2, 4, torch.float64)
    got = fastmnmf_mu("activation", _strided(x), W, g, _strided(H), EPS)
    assert torch.equal(got, fastmnmf_mu_plain("activation", x, W, g, H, EPS))


@pytest.mark.parametrize("entry", ENTRIES)
def test_k5_cost_by_hand(entry):
    """At M = S = 2, K = 10, 2049 bins and 470 frames, float32: W, g and H
    read once, x but for the weights, the result written once."""
    M, S, K, F_, T_ = 2, 2, 10, 2049, 470
    factors = S * F_ * K + S * F_ * M + S * K * T_
    result = {"weights": M * F_ * T_, "basis": S * F_ * K, "gains": S * F_ * M, "activation": S * K * T_, "fit": 1}
    n_bytes, flops = k5_cost(entry, M, S, K, F_, T_, 4)
    assert n_bytes == 4 * (factors + result[entry] + (0 if entry == "weights" else M * F_ * T_))
    per_element = {"weights": 2 * S * K + 1, "fit": 2 * S * K + 4}.get(entry, 6 * S * K + 3)
    extra = {"basis": 4 * S * K * M * F_, "gains": 4 * S * K * M * F_, "activation": 3 * S * K * T_}.get(entry, 0)
    assert flops == M * F_ * T_ * per_element + extra
    assert k5_cost(entry, M, S, K, F_, T_, 8)[0] == 2 * n_bytes


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_k5_call_charges_k5_cost_only(entry):
    ops = _operands(3, 2, 4, torch.float32)
    counter = CostCounter()
    with counter:
        fastmnmf_mu(entry, *ops, EPS)
    assert counter.charges == {"K5": 1} and list(counter.by_op) == ["kernel:K5"]
    assert (counter.bytes, counter.flops) == k5_cost(entry, 3, 2, 4, F, T, 4)


def test_an_iteration_charges_four_k5_calls():
    """The basis, the activations, the gains and K1's weights; the NLL is
    not counted."""
    X = _mixture(2, seed=7)
    counter = profiling.iteration_cost(port.FastMultichannelISNMF(n_basis=3, device="cpu"), X)
    assert counter.charges["K5"] == 4


def test_k5_launches_count_across_the_captured_loop(monkeypatch):
    """With each call standing for a launch, the emulated captured loop
    counts four for each step and one for each of the call's losses (the
    initial one eager), as the card's does, and the solver call's span
    carries them as ``k5_launches``."""
    route = mnmf_mu._fastmnmf_mu

    def launched(*args):
        mnmf_mu.fastmnmf_mu.launches += 1
        return route(*args)

    monkeypatch.setattr(mnmf_mu, "_fastmnmf_mu", launched)
    X = _mixture(2, seed=4, n_frames=16)
    iteration = 6
    solver = port.FastMultichannelISNMF(n_basis=2, device="cpu")
    solver._emulate_graph = True
    for call in range(2):  # the capture, then the cached graph
        before = mnmf_mu.fastmnmf_mu.launches
        np.random.seed(111)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            solver(X, iteration=iteration)
        assert mnmf_mu.fastmnmf_mu.launches - before == 5 * iteration + 1
        solve = [s for s in profiling.spans() if s.name == "solve"][-1]
        assert solve.attrs["k5_launches"] == 5 * iteration + 1
        assert solve.attrs["graph_replays"] == iteration - 1 and solve.attrs["graph_captures"] == 1 - call

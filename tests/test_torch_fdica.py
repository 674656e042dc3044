"""The port's FDICA against the JAX package on the CPU at float64, with the
permutation alignment: the whole loss trajectory (rtol 1e-9), the aligned
demixing filter and the output (atol 1e-8) at C = 2 and 3 (component
steps) and C = 5 (matrix steps); then warm start, checkpoints, callbacks
and the raise, and ``solve_permutation`` by both routes."""

import itertools
import shutil

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
from audio_source_separation_tpu.algorithm.permutation import solve_permutation as jax_solve_permutation
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.algorithm.permutation import greedy_permutations, solve_permutation
from audio_source_separation_tpu_torch.runtime.native import solve_permutation_native

from _torch_port import to_np
from conftest import make_mixture

ITERATIONS = 8
CLASSES = ["GradLaplaceFDICA", "NaturalGradLaplaceFDICA"]


@pytest.mark.parametrize("n_channels", [2, 3, 5])
@pytest.mark.parametrize("name", CLASSES)
def test_matches_jax_trajectory(rng, name, n_channels):
    X = make_mixture(rng, n_channels=n_channels, n_bins=17, n_frames=40)
    ref = getattr(jax_models, name)(lr=0.05)
    Y_ref = np.asarray(ref(X, iteration=ITERATIONS))
    ours = getattr(port, name)(lr=0.05, device="cpu")
    Y = ours(X, iteration=ITERATIONS)
    assert len(ours.loss) == ITERATIONS + 1
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    # the same aligned filter: the permutation applied is JAX's
    np.testing.assert_allclose(to_np(ours.demix_filter), np.asarray(ref.demix_filter), atol=1e-8)
    np.testing.assert_allclose(to_np(Y), Y_ref, atol=1e-8)
    assert solve_permutation.route in ("native", "numpy")


def _scrambled(rng, n_sources=2, n_bins=24, n_frames=64):
    """``tests/test_fdica_beamform_prox.py``'s case: distinct envelopes with
    half the bins' sources swapped."""
    env = np.stack([
        np.abs(np.sin(np.linspace(0, 6 * np.pi, n_frames))) + 0.05,
        np.abs(np.cos(np.linspace(0, 10 * np.pi, n_frames))) + 0.05,
    ])
    Y = (env[:, None, :] * (rng.randn(n_sources, n_bins, n_frames) * 0.05 + 1.0)).astype(np.complex128)
    W = np.tile(np.eye(2, dtype=np.complex128), (n_bins, 1, 1))
    flipped = rng.rand(n_bins) < 0.5
    Y[:, flipped] = Y[::-1][:, flipped]
    return W, Y, flipped


def test_solve_permutation_matches_jax(rng):
    W, Y, flipped = _scrambled(rng)
    W_ref = jax_solve_permutation(W, Y)
    W_ours = solve_permutation(torch.as_tensor(W), torch.as_tensor(Y))
    np.testing.assert_allclose(to_np(W_ours), W_ref, atol=1e-10)
    selected = np.argmax(np.abs(to_np(W_ours)[:, 0, :]), axis=-1)
    assert (selected == flipped).all() or (selected == ~flipped).all()


@pytest.mark.parametrize("n_sources", [2, 3, 4])
def test_native_and_numpy_routes_agree(n_sources):
    if shutil.which("cc") is None:
        pytest.skip("no C compiler (cc) to build native/permutation.c")
    r = np.random.RandomState(n_sources)
    P = np.abs(r.randn(20, n_sources, 30)) + 0.05
    P = P / np.sqrt(np.sum(P**2, axis=1, keepdims=True))
    order = np.argsort(np.sum(P @ P.transpose(0, 2, 1), axis=(1, 2)))
    native = solve_permutation_native(P, order)
    assert native is not None, "native/permutation.c did not build"
    expected = greedy_permutations(P, order)
    np.testing.assert_array_equal(native, expected)
    assert sorted(map(tuple, expected)) != [tuple(range(n_sources))] * 20  # not all identities


def test_numpy_route_past_eight_sources():
    P = np.abs(np.random.RandomState(0).randn(3, 9, 4))
    assert solve_permutation_native(P, np.arange(3)) is None
    perms = greedy_permutations(P[:, :3], np.arange(3))
    assert all(sorted(p) == [0, 1, 2] for p in perms)
    assert set(map(tuple, perms)) <= set(itertools.permutations(range(3)))


@pytest.mark.parametrize("name", CLASSES)
def test_warm_start_and_checkpoint(rng, tmp_path, name):
    """5 + 5 iterations from the saved state give the 10-iteration losses,
    and the output up to the global source order the alignment picks."""
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=40)
    full = getattr(port, name)(device="cpu")
    Y_full = to_np(full(X, iteration=10))
    half = getattr(port, name)(device="cpu")
    half(X, iteration=5)
    half.save_state(tmp_path / "fdica.npz")
    state = half.load_state(tmp_path / "fdica.npz")
    assert set(state) == {"demix_filter", "estimation"}
    Y = to_np(half(X, iteration=5, **state))
    np.testing.assert_allclose(half.loss[:6] + half.loss[7:], full.loss, rtol=1e-10)
    assert min(np.abs(Y[list(p)] - Y_full).max() for p in itertools.permutations(range(2))) < 1e-8


def test_callbacks_follow_jax(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=24)
    seen, seen_ref = [], []
    port.NaturalGradLaplaceFDICA(callbacks=lambda s: seen.append(to_np(s.demix_filter)), device="cpu")(X, iteration=3)
    jax_models.NaturalGradLaplaceFDICA(callbacks=lambda s: seen_ref.append(np.asarray(s.demix_filter)))(X, iteration=3)
    assert len(seen) == len(seen_ref) == 4  # after init and each iteration
    for a, b in zip(seen, seen_ref):
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_non_holonomic_raises(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16)
    with pytest.raises(NotImplementedError):
        port.NaturalGradLaplaceFDICA(is_holonomic=False, device="cpu")(X, iteration=1)

"""Shared inputs for the port's factorisation tests: seeded targets of each
model's kind and seeded initial factors, the same NumPy arrays for the JAX
package and the port; and the loss comparison of the MNMF tests."""

import numpy as np
import torch

N_BINS, N_FRAMES, N_BASIS, ITERATIONS = 17, 24, 3, 8


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def power_target(rng, n_bins=N_BINS, n_frames=N_FRAMES, rank=3):
    """A nonnegative near-low-rank ``(F, T)`` spectrogram."""
    T = np.abs(rng.randn(n_bins, rank)) + 0.1
    V = np.abs(rng.randn(rank, n_frames)) + 0.1
    return T @ V + 0.01 * np.abs(rng.randn(n_bins, n_frames))


def complex_target(rng, n_bins=N_BINS, n_frames=N_FRAMES):
    return (rng.randn(n_bins, n_frames) + 1j * rng.randn(n_bins, n_frames)) * 0.5


def tensor_target(rng, n_channels=3, n_bins=N_BINS, n_frames=N_FRAMES):
    """A nonnegative ``(C, F, T)`` power tensor."""
    return np.abs(rng.randn(n_channels, n_bins, n_frames)) ** 2


def covariance_target(rng, n_channels=2, n_bins=N_BINS, n_frames=N_FRAMES, spread=None):
    """Observed covariances ``(F, T, C, C)`` of two rank-1 spatial sources
    with low-rank spectra (``tests/test_nmf.py``'s recipe).  ``spread``
    scales the bins over ``logspace(-12, 6)`` and silences the first third
    of the frames, as real spectrograms do."""
    a = rng.randn(n_bins, 2, n_channels) + 1j * rng.randn(n_bins, 2, n_channels)
    spatial = a[..., :, None] * a[..., None, :].conj()
    spectrum = np.abs(rng.randn(n_bins, 2)) + 0.1
    activation = np.abs(rng.randn(2, n_frames)) + 0.1
    if spread:
        spectrum = spectrum * np.logspace(-12, 6, n_bins)[:, None]
        activation[:, : n_frames // 3] = 1e-14
        return np.einsum("fncd,fn,nt->ftcd", spatial, spectrum, activation)
    return np.einsum("fncd,fn,nt->ftcd", spatial, spectrum, activation) + 0.01 * np.eye(n_channels)


def factors(kind, target, n_basis=N_BASIS, seed=5):
    """Seeded initial factors for a model of ``kind`` ("nmf", "complex",
    "covariance", "ntf") on ``target``."""
    r = np.random.RandomState(seed)
    if kind == "ntf":
        n_channels, n_bins, n_frames = target.shape
        return {
            "partitioning": r.rand(n_channels, n_basis),
            "basis": r.rand(n_bins, n_basis),
            "activation": r.rand(n_basis, n_frames),
        }
    if kind == "covariance":
        n_bins, n_frames, n_channels, _ = target.shape
        return {
            "spatial": np.tile(np.eye(n_channels, dtype=complex), (n_bins, n_basis, 1, 1)),
            "basis": r.rand(n_bins, n_basis),
            "activation": r.rand(n_basis, n_frames),
        }
    n_bins, n_frames = target.shape
    out = {"basis": r.rand(n_bins, n_basis), "activation": r.rand(n_basis, n_frames)}
    if kind == "complex":
        out["phase"] = np.tile(np.angle(target)[:, None, :], (1, n_basis, 1)) + 0.1 * r.randn(n_bins, n_basis, n_frames)
    return out


def make_target(kind, rng, n_channels=2):
    if kind == "nmf":
        return power_target(rng)
    if kind == "complex":
        return complex_target(rng)
    if kind == "ntf":
        return tensor_target(rng)
    return covariance_target(rng, n_channels=n_channels)


def assert_losses_match(ours, ref, rtol=1e-9, first_rtol=None):
    """Loss trajectories at ``rtol``.  Where ``first_rtol`` is given, the
    loss holds a constant of the data whose value is rounding noise (Sawada
    MNMF's rank-1 log-determinant): the increments ``L_k - L_0`` are held at
    ``rtol`` of ``|L_0|`` and ``L_0`` at ``first_rtol``."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    if first_rtol is None:
        np.testing.assert_allclose(ours, ref, rtol=rtol)
        return
    np.testing.assert_allclose(ours[0], ref[0], rtol=first_rtol)
    np.testing.assert_allclose(ours - ours[0], ref - ref[0], rtol=0, atol=rtol * abs(ref[0]))

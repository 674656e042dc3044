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
    reference loss holds a constant of the data whose value is rounding noise
    (the JAX package's Sawada MNMF, :func:`jax_sawada_losses`): the
    increments ``L_k - L_0`` are held at ``rtol`` of ``|L_0|`` and ``L_0`` at
    ``first_rtol``."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    if first_rtol is None:
        np.testing.assert_allclose(ours, ref, rtol=rtol)
        return
    np.testing.assert_allclose(ours[0], ref[0], rtol=first_rtol)
    np.testing.assert_allclose(ours - ours[0], ref - ref[0], rtol=0, atol=rtol * abs(ref[0]))


SAWADA_FIELDS = ("latent", "spatial", "basis", "activation")


class SawadaStates:
    """A callback keeping the ``(latent, spatial, basis, activation)`` of
    each of a Sawada MNMF call's losses (after init and every iteration)."""

    def __init__(self):
        self.states = []

    def __call__(self, solver):
        self.states.append(tuple(np.array(to_np(getattr(solver, field))) for field in SAWADA_FIELDS))


def jax_sawada_losses(solver, X, losses, states):
    """The JAX package's Sawada MNMF ``losses`` with the observed covariance
    taken as the port takes it.  ``solver`` is the JAX solver, ``X (C, F,
    T)`` the mixture, ``states`` the :class:`SawadaStates` of the losses.

    The eigenvalues of the rank-1 ``x x^H`` are ``|x|^2`` and ``C - 1``
    zeros.  The JAX package takes them from its closed form, which returns
    the zeros as rounding noise ``w`` (about 1e-16 of the trace at C = 2,
    1e-8 at C = 3, where the trigonometric form loses half the digits), far
    above the ``eps tr`` ridge at C = 3; the port takes them as 0.  So the
    JAX package's log-determinant of the observed covariance differs by a
    constant of the data, taken out here from the JAX package's own jitted
    closed form, and its shift by ``s = max(-min w, 0)``, which adds ``s
    tr((X^ + (eps tr X^ + eps) I)^-1)`` to each loss's trace term, taken out
    from the state."""
    import jax
    import jax.numpy as jnp
    from audio_source_separation_tpu.ops import fast_linalg as jax_linalg
    from audio_source_separation_tpu.ops.ip_components import pair_products_planes

    eps, C = solver.eps, X.shape[0]
    P = solver._cov_planes_complex({"covariance_planes": pair_products_planes(jnp.asarray(X))})
    shifted = np.asarray(jax.jit(lambda P: jax_linalg.psd_parts_planes(P, eps=eps)[1])(P))
    s = np.maximum(-np.asarray(jax.jit(jax_linalg.hermitian_eigvalsh_planes)(P)).min(axis=0), 0.0)  # (F, T)
    power = (np.abs(X) ** 2).sum(axis=0)
    ridge = eps * power + eps
    data = np.log(np.maximum(shifted + eps, eps)).sum() - (np.log(power + ridge) + (C - 1) * np.log(ridge)).sum()
    assert len(losses) == len(states)
    out = []
    for loss, (Z, H, T, V) in zip(losses, states):
        Xh = np.einsum("sk,fk,kt,fscd->ftcd", Z, T, V, H)
        Xh = Xh + (eps * np.trace(Xh, axis1=-2, axis2=-1).real + eps)[..., None, None] * np.eye(C)
        out.append(loss + data - (s * np.trace(np.linalg.inv(Xh), axis1=-2, axis2=-1).real).sum())
    return np.array(out)

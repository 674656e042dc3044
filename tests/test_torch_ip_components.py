"""Parity of the port's component-layout IP math with the JAX package
(float64 on the CPU, rtol 1e-10), plus the float32 sign guarantee of the
Cholesky form of ``w^H U w``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_source_separation_tpu.ops import fast_linalg as jfl
from audio_source_separation_tpu.ops import ip_components as jip
from audio_source_separation_tpu.utils import flooring as jflo
from audio_source_separation_tpu_torch.ops import fast_linalg as tfl
from audio_source_separation_tpu_torch.ops import ip_components as tip
from audio_source_separation_tpu_torch.utils import flooring as tflo

from conftest import make_mixture

RTOL = 1e-10
F, T = 13, 21


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _nested(fn, tree):
    if isinstance(tree, (list, tuple)):
        return [_nested(fn, t) for t in tree]
    return fn(tree)


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(_nested(_np, a), _nested(_np, b), rtol=rtol, atol=atol)


def _rows(rng, n, c):
    return [[rng.randn(F) + 1j * rng.randn(F) for _ in range(c)] for _ in range(n)]


def _psd_components(rng, C, n_sources):
    """U[n][c][d] complex (F,) Hermitian PSD, from a random mixture."""
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    w = np.abs(rng.randn(n_sources, T)) + 0.1
    U = np.einsum("nt,cft,dft->ncdf", w, X, X.conj()) / T
    return [[[U[n, c, d] for d in range(C)] for c in range(C)] for n in range(n_sources)]


def _jax(tree):
    return _nested(jnp.asarray, tree)


def _torch(tree):
    return _nested(torch.as_tensor, tree)


CHANNELS = pytest.mark.parametrize("C", [2, 3, 4])


@CHANNELS
def test_plane_index(C):
    assert tip._plane_index(C) == jip._plane_index(C)


@CHANNELS
def test_pair_products_planes(rng, C):
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    _close(tip.pair_products_planes(torch.as_tensor(X)), jip.pair_products_planes(jnp.asarray(X)))


@CHANNELS
def test_frame_power_sums(rng, C):
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    rows = _rows(rng, C, C)
    ours = tip.frame_power_sums(_torch(rows), tip.pair_products_planes(torch.as_tensor(X)))
    ref = jip.frame_power_sums(_jax(rows), jip.pair_products_planes(jnp.asarray(X)))
    _close(ours, ref)
    assert (_np(ours) >= 0).all()


@CHANNELS
def test_covariance_planes(rng, C):
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    w = np.abs(rng.randn(C, T)) + 0.1
    ours = tip._covariance_planes(tip.pair_products_planes(torch.as_tensor(X)), torch.as_tensor(w))
    ref = jip._covariance_planes(jip.pair_products_planes(jnp.asarray(X)), jnp.asarray(w))
    _close(ours, ref)


@CHANNELS
def test_weighted_covariance_components(rng, C):
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    w = np.abs(rng.randn(C, T)) + 0.1
    ours = tip.weighted_covariance_components(
        tip.pair_products_planes(torch.as_tensor(X)), torch.as_tensor(w)
    )
    ref = jip.weighted_covariance_components(jip.pair_products_planes(jnp.asarray(X)), jnp.asarray(w))
    _close(ours, ref)


@CHANNELS
def test_separate_components(rng, C):
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    rows = _rows(rng, C, C)
    _close(
        tip.separate_components(_torch(rows), torch.as_tensor(X)),
        jip.separate_components(_jax(rows), jnp.asarray(X)),
    )


@CHANNELS
def test_det_components(rng, C):
    M = _rows(rng, C, C)
    _close(tip.det_components(_torch(M), C), jip.det_components(_jax(M), C))


@CHANNELS
def test_solve_column_components(rng, C):
    M = _rows(rng, C, C)
    for col in range(C):
        _close(
            tip.solve_column_components(_torch(M), C, col),
            jip.solve_column_components(_jax(M), C, col),
        )


@CHANNELS
def test_cholesky_quadratic_components(rng, C):
    U = _psd_components(rng, C, 1)[0]
    w = _rows(rng, 1, C)[0]
    ours = tip.cholesky_quadratic_components(_torch(U), _torch(w))
    _close(ours, jip.cholesky_quadratic_components(_jax(U), _jax(w)))
    direct = sum(np.conj(w[c]) * U[c][d] * w[d] for c in range(C) for d in range(C)).real
    np.testing.assert_allclose(_np(ours), direct, rtol=1e-9)


@CHANNELS
@pytest.mark.parametrize("guard", ["one_norm", "none"])
def test_ip_update_components(rng, C, guard):
    U = _psd_components(rng, C, C)
    rows = _rows(rng, C, C)
    ours = tip.ip_update_components(_torch(rows), _torch(U), guard=guard)
    ref = jip.ip_update_components(_jax(rows), _jax(U), guard=guard)
    _close(ours, ref)


@CHANNELS
def test_auxiva_ip_step_components(rng, C):
    """Three chained iterations from the identity filter: the filters, the
    estimates and each iteration's NLL."""
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    rows = [[np.full(F, 1.0 + 0j if n == c else 0j) for c in range(C)] for n in range(C)]
    ours = (_torch(rows), torch.as_tensor(X), tip.pair_products_planes(torch.as_tensor(X)))
    theirs = (_jax(rows), jnp.asarray(X), jip.pair_products_planes(jnp.asarray(X)))
    for _ in range(3):
        W_o, Y_o, nll_o = tip.auxiva_ip_step_components(torch.as_tensor(X), ours[0], ours[1], ours[2])
        W_t, Y_t, nll_t = jip.auxiva_ip_step_components(jnp.asarray(X), theirs[0], theirs[1], theirs[2])
        _close(W_o, W_t)
        _close(Y_o, Y_t, atol=1e-12)
        np.testing.assert_allclose(float(nll_o), float(nll_t), rtol=RTOL)
        ours, theirs = (W_o, Y_o, ours[2]), (W_t, Y_t, theirs[2])


@CHANNELS
def test_log_abs_det_components(rng, C):
    rows = _rows(rng, C, C)
    _close(tip.log_abs_det_components(_torch(rows), C), jip.log_abs_det_components(_jax(rows), C))


@CHANNELS
def test_cholesky_quadratic_nonnegative_float32(rng, C):
    """Weights spanning 1e-5..1e5 on a nearly rank-one mixture: the direct
    float32 sum ``sum w_c^* U_cd w_d`` cancels below zero in some bins, the
    Cholesky sum of squares never does."""
    n_bins, n_frames = 512, 64
    base = rng.randn(n_bins, n_frames) + 1j * rng.randn(n_bins, n_frames)
    X = np.stack(
        [base + 1e-5 * (rng.randn(n_bins, n_frames) + 1j * rng.randn(n_bins, n_frames)) for _ in range(C)]
    )
    weights = 10.0 ** rng.uniform(-5, 5, size=n_frames)
    U = np.einsum("t,cft,dft->cdf", weights, X, X.conj()) / n_frames
    U32 = [[torch.as_tensor(U[c, d].astype(np.complex64)) for d in range(C)] for c in range(C)]
    v = np.zeros((C, n_bins), dtype=np.complex64)
    v[0], v[1] = 1e2, -1e2
    v32 = [torch.as_tensor(v[c]) for c in range(C)]
    direct = sum(v32[c].conj() * U32[c][d] * v32[d] for c in range(C) for d in range(C)).real
    assert (direct < 0).any()
    assert (tip.cholesky_quadratic_components(U32, v32) >= 0).all()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_det_inv_planes(rng, n):
    P = rng.randn(n, n, F) + 1j * rng.randn(n, n, F)
    _close(tfl.det_planes(torch.as_tensor(P)), jfl.det_planes(jnp.asarray(P)))
    _close(tfl.inv_planes(torch.as_tensor(P)), jfl.inv_planes(jnp.asarray(P)))


def test_flooring(rng):
    x = rng.randn(4, 5) * 1e-11
    _close(tflo.floor_below(torch.as_tensor(x)), jflo.floor_below(jnp.asarray(x)))
    A = rng.randn(3, 4, 4)
    _close(tflo.identity_ridge(torch.as_tensor(A), 1e-3), jflo.identity_ridge(jnp.asarray(A), 1e-3))
    assert (tflo.EPS, tflo.THRESHOLD) == (1e-12, 1e12)

"""The port's spatial-update ops against the JAX package on the CPU at
float64: the trailing-axes closed forms, ``ops/ip.py``, ``ops/iss.py``,
``ops/eig2.py``, the IP2 and gradient-step additions to
``ops/ip_components.py``, and ``transform/pca.py``.

Tolerance rtol 1e-10 throughout: the port repeats the JAX package's
formulas, so the two differ by summation order only.  The PCA is compared
up to one sign per (component, bin): an eigenvector is defined up to its
phase, and the two packages' ``eigh`` routines pick different signs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_source_separation_tpu.ops import eig2 as jeig
from audio_source_separation_tpu.ops import fast_linalg as jfl
from audio_source_separation_tpu.ops import ip as jip
from audio_source_separation_tpu.ops import ip_components as jic
from audio_source_separation_tpu.ops.iss import iss_sweep as j_iss_sweep
from audio_source_separation_tpu.transform.pca import pca as j_pca
from audio_source_separation_tpu_torch.ops import eig2 as teig
from audio_source_separation_tpu_torch.ops import fast_linalg as tfl
from audio_source_separation_tpu_torch.ops import ip as tip
from audio_source_separation_tpu_torch.ops import ip_components as tic
from audio_source_separation_tpu_torch.ops.iss import iss_sweep as t_iss_sweep
from audio_source_separation_tpu_torch.transform import pca as t_pca

from conftest import make_mixture

RTOL = 1e-10
F, T = 13, 24


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _nested(fn, tree):
    if isinstance(tree, (list, tuple)):
        return [_nested(fn, t) for t in tree]
    return fn(tree)


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(_nested(_np, a), _nested(_np, b), rtol=rtol, atol=atol)


def _complex(rng, *shape):
    return rng.randn(*shape) + 1j * rng.randn(*shape)


def _covariances(rng, C, n_sources, n_bins=F):
    """``U (N, F, C, C)`` Hermitian PSD from a random mixture."""
    X = make_mixture(rng, n_channels=C, n_bins=n_bins, n_frames=T)
    w = np.abs(rng.randn(n_sources, T)) + 0.1
    return np.einsum("nt,cft,dft->nfcd", w, X, X.conj()) / T


# ---- ops/fast_linalg.py, trailing-axes forms ---------------------------------


@pytest.mark.parametrize("n", [2, 3])
def test_closed_form_det_inv(rng, n):
    A = _complex(rng, F, n, n)
    jdet, jinv = (jfl.det_2x2, jfl.inv_2x2) if n == 2 else (jfl.det_3x3, jfl.inv_3x3)
    tdet, tinv = (tfl.det_2x2, tfl.inv_2x2) if n == 2 else (tfl.det_3x3, tfl.inv_3x3)
    _close(tdet(torch.as_tensor(A)), jdet(jnp.asarray(A)))
    _close(tinv(torch.as_tensor(A)), jinv(jnp.asarray(A)))
    _close(tinv(torch.as_tensor(A)), np.linalg.inv(A))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_batched_det_inv_logdet(rng, n):
    A = _complex(rng, 2, F, n, n)
    _close(tfl.batched_det(torch.as_tensor(A)), jfl.batched_det(jnp.asarray(A)))
    _close(tfl.batched_inv(torch.as_tensor(A)), jfl.batched_inv(jnp.asarray(A)))
    _close(tfl.batched_log_abs_det(torch.as_tensor(A)), jfl.batched_log_abs_det(jnp.asarray(A)))


# ---- ops/ip.py ------------------------------------------------------------------


def _ill_conditioned(rng, C):
    """``(F, C, C)``: well-conditioned bins, and bins whose condition number
    is about 1e13, so every guard's mask is mixed."""
    A = _complex(rng, F, C, C)
    A[::3, :, -1] = A[::3, :, 0] * (1 + 1e-13)
    return A


@pytest.mark.parametrize("guard", ["one_norm", "svd", "none"])
@pytest.mark.parametrize("C", [2, 4])
def test_cond_guard(rng, guard, C):
    A = _ill_conditioned(rng, C)
    ours = _np(tip.cond_guard(torch.as_tensor(A), guard=guard))
    np.testing.assert_array_equal(ours, np.asarray(jip.cond_guard(jnp.asarray(A), guard=guard)))
    assert ours.all() == (guard == "none") and ours.any()
    with pytest.raises(ValueError):
        tip.cond_guard(torch.as_tensor(A), guard="max")


def test_psd_quadratic_form(rng):
    U = _covariances(rng, 3, 1)[0]
    w = _complex(rng, F, 3)
    ours = tip.psd_quadratic_form(torch.as_tensor(U), torch.as_tensor(w))
    _close(ours, jip.psd_quadratic_form(jnp.asarray(U), jnp.asarray(w)))
    assert (_np(ours) >= 0).all()


@pytest.mark.parametrize(
    "C,guard,denom_floor",
    [(2, "one_norm", None), (3, "none", None), (3, "one_norm", 0.5), (2, "svd", None), (5, "one_norm", None),
     (5, "svd", 0.5)],
)
def test_ip_update(rng, C, guard, denom_floor):
    """Component path (one_norm/none at C <= 4) and matrix path (svd, C > 4)."""
    W = np.eye(C) + 0.3 * _complex(rng, F, C, C)
    U = _covariances(rng, C, C)
    ours = tip.ip_update(torch.as_tensor(W), torch.as_tensor(U), guard=guard, denom_floor=denom_floor)
    ref = jip.ip_update(jnp.asarray(W), jnp.asarray(U), guard=guard, denom_floor=denom_floor)
    _close(ours, ref)


# ---- ops/iss.py -----------------------------------------------------------------


@pytest.mark.parametrize("per_bin", [False, True])
@pytest.mark.parametrize("compat", [False, True])
def test_iss_sweep(rng, per_bin, compat):
    Y = make_mixture(rng, n_channels=3, n_bins=F, n_frames=T)
    inv_R = np.abs(rng.randn(*((3, F, T) if per_bin else (3, T)))) + 0.1
    ours = t_iss_sweep(torch.as_tensor(Y), torch.as_tensor(inv_R), compat=compat)
    _close(ours, j_iss_sweep(jnp.asarray(Y), jnp.asarray(inv_R), compat=compat))


# ---- ops/eig2.py ----------------------------------------------------------------


def _eig_inputs(rng):
    """General complex 2 x 2 matrices, with diagonal ones (the degenerate
    eigenvector branch) and one with a repeated eigenvalue mixed in."""
    A = _complex(rng, F, 2, 2)
    A[1, 0, 1] = A[1, 1, 0] = 0
    A[2] = np.diag([2.0 + 1j, 2.0 + 1j])
    A[3, 1, 0] = 0
    return A


def test_eig2x2(rng):
    A = _eig_inputs(rng)
    vals, vecs = teig.eig2x2(torch.as_tensor(A))
    jvals, jvecs = jeig.eig2x2(jnp.asarray(A))
    _close(vals, jvals)
    _close(vecs, jvecs)
    v = _np(vecs)
    np.testing.assert_allclose(A @ v, v * _np(vals)[:, None, :], atol=1e-12)


def test_eig2x2_planes(rng):
    A = _eig_inputs(rng)
    entries = [A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]]
    ours = teig.eig2x2_planes(*[torch.as_tensor(e) for e in entries])
    ref = jeig.eig2x2_planes(*[jnp.asarray(e) for e in entries])
    _close(ours[0], ref[0])  # eigenvalues
    _close(ours[1], ref[1])  # eigenvectors


def _hermitian_pair(rng):
    U = _covariances(rng, 2, 2)
    return U[0], U[1]


def test_generalized_eig2x2_descending(rng):
    Vm, Vn = _hermitian_pair(rng)
    ours = teig.generalized_eig2x2_descending(torch.as_tensor(Vm), torch.as_tensor(Vn))
    _close(ours, jeig.generalized_eig2x2_descending(jnp.asarray(Vm), jnp.asarray(Vn)))


def test_generalized_eig2x2_descending_planes(rng):
    Vm, Vn = _hermitian_pair(rng)

    def planes(V, lib):
        return [[lib(V[:, a, b]) for b in range(2)] for a in range(2)]

    ours = teig.generalized_eig2x2_descending_planes(planes(Vm, torch.as_tensor), planes(Vn, torch.as_tensor))
    ref = jeig.generalized_eig2x2_descending_planes(planes(Vm, jnp.asarray), planes(Vn, jnp.asarray))
    _close(ours, ref)


# ---- ops/ip_components.py, the IP2 and gradient additions -----------------------


@pytest.mark.parametrize("C", [2, 3])
def test_weighted_covariance_planes_array_and_stack(rng, C):
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    w = np.abs(rng.randn(2, T)) + 0.1
    planes_t = tic.pair_products_planes(torch.as_tensor(X))
    planes_j = jic.pair_products_planes(jnp.asarray(X))
    _close(
        tic.weighted_covariance_planes_array(planes_t, torch.as_tensor(w)),
        jic.weighted_covariance_planes_array(planes_j, jnp.asarray(w)),
    )
    _close(
        tic.weighted_covariance_planes_stack(planes_t, torch.as_tensor(w)),
        jic.weighted_covariance_planes_stack(planes_j, jnp.asarray(w)),
    )


@pytest.mark.parametrize("guard,denom_floor", [("one_norm", None), ("none", 0.5)])
def test_ip_sweep_from_planes(rng, guard, denom_floor):
    X = make_mixture(rng, n_channels=3, n_bins=F, n_frames=T)
    W = np.eye(3) + 0.3 * _complex(rng, F, 3, 3)
    w = np.abs(rng.randn(3, T)) + 0.1
    ours = tic.ip_sweep_from_planes(
        torch.as_tensor(W), tic.pair_products_planes(torch.as_tensor(X)), torch.as_tensor(w),
        guard=guard, denom_floor=denom_floor,
    )
    ref = jic.ip_sweep_from_planes(
        jnp.asarray(W), jic.pair_products_planes(jnp.asarray(X)), jnp.asarray(w),
        guard=guard, denom_floor=denom_floor,
    )
    _close(ours, ref)


@pytest.mark.parametrize("C,m,n,guard", [(2, 0, 1, "one_norm"), (2, 1, 0, "none"), (3, 1, 2, "one_norm"), (3, 2, 0, "none")])
def test_ip2_pair_update_planes(rng, C, m, n, guard):
    W = np.eye(C) + 0.3 * _complex(rng, F, C, C)
    U = np.transpose(_covariances(rng, C, 2), (0, 2, 3, 1))  # (2, C, C, F)
    ours = tic.ip2_pair_update_planes(
        torch.as_tensor(W), torch.as_tensor(U), torch.tensor(m), torch.tensor(n), guard=guard
    )
    ref = jic.ip2_pair_update_planes(jnp.asarray(W), jnp.asarray(U), jnp.asarray(m), jnp.asarray(n), guard=guard)
    _close(ours, ref)


def test_dynamic_set_row(rng):
    W = _complex(rng, F, 3, 3)
    row = _complex(rng, F, 3)
    ours = tic._dynamic_set_row(torch.as_tensor(W), torch.tensor(1), torch.as_tensor(row))
    _close(ours, jic._dynamic_set_row(jnp.asarray(W), jnp.asarray(1), jnp.asarray(row)))
    expected = W.copy()
    expected[:, 1] = row
    np.testing.assert_array_equal(_np(ours), expected)


@pytest.mark.parametrize("step", ["natural", "plain"])
@pytest.mark.parametrize("C", [2, 3])
def test_grad_step_components(rng, step, C):
    X = make_mixture(rng, n_channels=C, n_bins=F, n_frames=T)
    W = np.eye(C)[:, :, None] + 0.3 * _complex(rng, C, C, F)
    rows = [[W[s, c] for c in range(C)] for s in range(C)]
    Y = np.einsum("scf,cft->sft", W, X)
    Phi = Y / np.sqrt(np.sum(np.abs(Y) ** 2, axis=1, keepdims=True))
    second = Y if step == "natural" else X
    fn_t = tic.natural_grad_step_components if step == "natural" else tic.plain_grad_step_components
    fn_j = jic.natural_grad_step_components if step == "natural" else jic.plain_grad_step_components
    ours = fn_t(_nested(torch.as_tensor, rows), torch.as_tensor(second), torch.as_tensor(Phi), 0.1)
    _close(ours, fn_j(_nested(jnp.asarray, rows), jnp.asarray(second), jnp.asarray(Phi), 0.1))


# ---- transform/pca.py -------------------------------------------------------------


@pytest.mark.parametrize("n_sources", [None, 2])
def test_pca(rng, n_sources):
    X = make_mixture(rng, n_channels=4, n_bins=F, n_frames=T)
    ours = _np(t_pca(torch.as_tensor(X), n_sources=n_sources))
    ref = np.asarray(j_pca(X, n_sources=n_sources))
    assert ours.shape == ref.shape == ((n_sources or 4), F, T)
    # one unit phase per (component, bin) aligns the two
    inner = np.sum(ours * ref.conj(), axis=-1)
    phase = inner / np.abs(inner)
    np.testing.assert_allclose(np.abs(phase), 1.0, rtol=RTOL)
    np.testing.assert_allclose(ours, phase[..., None] * ref, rtol=0, atol=RTOL * np.abs(ref).max())
    with pytest.raises(ValueError):
        t_pca(torch.as_tensor(X[0]))

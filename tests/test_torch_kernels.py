"""The plain versions of the port's two kernels against the JAX package on
the CPU.

K1 (``ops/cov_kernel.py``) against the Pallas covariance kernel in
interpret mode and the planes contraction; K2 (``ops/fused_ip.py``), with
either contrast, against the fused Pallas iteration in interpret mode and
the component-layout AuxIVA-IP step.  The CUDA kernels against these plain versions are in
``test_torch_cuda_kernels.py``, which needs a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_source_separation_tpu.ops import ip_components as jip
from audio_source_separation_tpu.ops.covariance import weighted_covariance as j_weighted_covariance
from audio_source_separation_tpu.ops.pallas_fused import fused_auxiva_ip_iter as fused_auxiva_ip_iter_pallas
from audio_source_separation_tpu.ops.pallas_fused import (
    fused_auxiva_ip_run,
    identity_w_planes,
    pack_planes,
    pad_bins,
    pad_frames,
)
from audio_source_separation_tpu.ops.pallas_kernels import weighted_covariance_pallas
from audio_source_separation_tpu_torch.ops import ip_components as tip
from audio_source_separation_tpu_torch.ops.cov_kernel import (
    weighted_covariance_planes,
    weighted_covariance_planes_plain,
)
from audio_source_separation_tpu_torch.ops.covariance import (
    weighted_covariance,
    weighted_covariance_auto,
)
from audio_source_separation_tpu_torch.ops.fused_ip import (
    CONTRASTS,
    SMEM_LIMIT,
    STATIC_SMEM,
    fused_auxiva_ip_iter,
    fused_auxiva_ip_iter_plain,
    k2_launch_plan,
)

from conftest import make_mixture

EPS = 1e-12


def _weights(rng, n, T, dtype):
    return (np.abs(rng.randn(n, T)) + 0.1).astype(dtype)


@pytest.mark.parametrize("C", [2, 3, 4])
def test_k1_plain_matches_pallas_interpret_f32(rng, C):
    """f32 bounds of test_parallel.py::test_pallas_covariance_interpret_matches_xla."""
    X = make_mixture(rng, n_channels=C, n_bins=70, n_frames=33, dtype=np.complex64)
    w = _weights(rng, C, 33, np.float32)
    ours = weighted_covariance_auto(torch.as_tensor(X), torch.as_tensor(w))
    ref = weighted_covariance_pallas(jnp.asarray(X), jnp.asarray(w), f_tile=32, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    compact = weighted_covariance_planes_plain(torch.as_tensor(X), torch.as_tensor(w))
    ref_compact = jip._covariance_planes(jip.pair_products_planes(jnp.asarray(X)), jnp.asarray(w))
    np.testing.assert_allclose(compact.numpy(), np.asarray(ref_compact), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C", [2, 3, 4])
def test_k1_plain_matches_jax_f64(rng, C):
    X = make_mixture(rng, n_channels=C, n_bins=19, n_frames=27)
    w = _weights(rng, C, 27, np.float64)
    Xt, wt = torch.as_tensor(X), torch.as_tensor(w)
    compact = weighted_covariance_planes(Xt, wt)  # CPU tensor: the plain version
    assert compact.shape == (C * C, 19, C)
    ref = jip._covariance_planes(jip.pair_products_planes(jnp.asarray(X)), jnp.asarray(w))
    np.testing.assert_allclose(compact.numpy(), np.asarray(ref), rtol=1e-10)
    U_ref = np.asarray(j_weighted_covariance(jnp.asarray(X), jnp.asarray(w)))
    np.testing.assert_allclose(weighted_covariance_auto(Xt, wt).numpy(), U_ref, rtol=1e-10)
    np.testing.assert_allclose(weighted_covariance(Xt, wt).numpy(), U_ref, rtol=1e-10)


@pytest.mark.parametrize("C,N", [(1, 1), (5, 5), (3, 2), (2, 6), (6, 3)])
def test_k1_plain_any_shape_matches_jax_f64(rng, C, N):
    """K1 takes any C and N, as the Pallas kernel's loops do: the compact
    planes and the assembled matrices against the JAX package."""
    X = make_mixture(rng, n_channels=C, n_bins=13, n_frames=21)
    w = _weights(rng, N, 21, np.float64)
    Xt, wt = torch.as_tensor(X), torch.as_tensor(w)
    compact = weighted_covariance_planes(Xt, wt)
    assert compact.shape == (C * C, 13, N)
    ref = jip._covariance_planes(jip.pair_products_planes(jnp.asarray(X)), jnp.asarray(w))
    np.testing.assert_allclose(compact.numpy(), np.asarray(ref), rtol=1e-10)
    U_ref = np.asarray(j_weighted_covariance(jnp.asarray(X), jnp.asarray(w)))
    np.testing.assert_allclose(weighted_covariance_auto(Xt, wt).numpy(), U_ref, rtol=1e-10, atol=1e-14)


def test_weighted_covariance_per_bin_weights(rng):
    X = make_mixture(rng, n_channels=3, n_bins=11, n_frames=16)
    w = np.abs(rng.randn(3, 11, 16)) + 0.1
    U_ref = np.asarray(j_weighted_covariance(jnp.asarray(X), jnp.asarray(w)))
    ours = weighted_covariance_auto(torch.as_tensor(X), torch.as_tensor(w))
    np.testing.assert_allclose(ours.numpy(), U_ref, rtol=1e-10)


def _stereo(rng, F, T, dtype):
    S = rng.randn(2, F, T) * np.abs(rng.randn(2, 1, T)) + 1j * rng.randn(2, F, T)
    A = np.array([[1.0, 0.7], [0.6, 1.0]])
    return np.einsum("cn,nft->cft", A, S).astype(dtype)


def _identity(F, dtype):
    return torch.as_tensor(np.eye(2, dtype=dtype)[:, :, None] * np.ones(F, dtype=dtype))


def _run_plain(X, W, iterations, eps=EPS):
    """K2 plain version iterated, from W and the psum of W X."""
    psum = torch.sum(torch.abs(tip.separate_components(
        [[W[s, c] for c in range(2)] for s in range(2)], X)) ** 2, dim=1)
    nlls = []
    for _ in range(iterations):
        W, psum, _, nll = fused_auxiva_ip_iter(X, W, psum, eps=eps)
        nlls.append(float(nll))
    return W, psum, np.array(nlls)


def test_k2_plain_matches_pallas_interpret_f32(rng):
    """f32 bounds of test_pallas_fused.py (NLL rtol 3e-5, W atol 3e-4)."""
    X = _stereo(rng, 200, 37, np.complex64)
    F = X.shape[1]
    W, _, nlls = _run_plain(torch.as_tensor(X), _identity(F, np.complex64), 8)

    X4 = pack_planes(jnp.asarray(X))
    X4p, _ = pad_bins(X4, tile=128)
    X4p, T_true = pad_frames(X4p, 128)
    Wc, nlls_ref, _ = jax.jit(
        lambda a, b: fused_auxiva_ip_run(a, b, 8, eps=EPS, interpret=True, n_frames=T_true)
    )(X4p, identity_w_planes(X4p.shape[1]))
    np.testing.assert_allclose(nlls, np.asarray(nlls_ref), rtol=3e-5)
    Wf = np.asarray(Wc).reshape(2, 2, 2, -1)
    np.testing.assert_allclose(W.numpy(), Wf[:, :, 0, :F] + 1j * Wf[:, :, 1, :F], atol=3e-4)


def test_k2_gauss_plain_matches_pallas_interpret_f32(rng):
    """The Gauss contrast: the Pallas iteration takes ``1/R`` as an input,
    so it is driven with ``1/max(psum/F, eps)`` and the Gauss NLL is taken
    outside it; same f32 bounds as the Laplace case above."""
    X = _stereo(rng, 200, 37, np.complex64)
    F, T_true = X.shape[1], X.shape[2]
    W = _identity(F, np.complex64)
    Xt = torch.as_tensor(X)
    psum = torch.sum(torch.abs(Xt) ** 2, dim=1)
    nlls = []
    for _ in range(6):
        W, psum, _, nll = fused_auxiva_ip_iter(Xt, W, psum, eps=EPS, contrast="gauss")
        nlls.append(float(nll))

    X4p, _ = pad_bins(pack_planes(jnp.asarray(X)), tile=128)
    X4p, _ = pad_frames(X4p, 128)
    step = jax.jit(lambda X4, Wc, winv: fused_auxiva_ip_iter_pallas(X4, Wc, winv, interpret=True, n_frames=T_true))
    Wc = identity_w_planes(X4p.shape[1])
    psum_ref = jnp.sum(X4p**2, axis=1).reshape(2, 2, -1).sum(axis=1)  # sum_f |x_n|^2 for W = I
    nlls_ref = []
    for _ in range(6):
        winv = 1.0 / jnp.maximum(psum_ref / F, EPS)
        Wc, psum_ref, logdet = step(X4p, Wc, winv)
        p = psum_ref[:, :T_true]
        nlls_ref.append(float(F * jnp.sum(jnp.log(jnp.maximum(p / F, EPS))) - 2.0 * T_true * logdet))
    np.testing.assert_allclose(nlls, nlls_ref, rtol=3e-5)
    Wf = np.asarray(Wc).reshape(2, 2, 2, -1)
    np.testing.assert_allclose(W.numpy(), Wf[:, :, 0, :F] + 1j * Wf[:, :, 1, :F], atol=3e-4)
    np.testing.assert_allclose(psum.numpy(), np.asarray(psum_ref)[:, :T_true], rtol=1e-4)


def test_k2_rejects_an_unknown_contrast(rng):
    X = torch.as_tensor(_stereo(rng, 5, 8, np.complex128))
    psum = torch.sum(torch.abs(X) ** 2, dim=1)
    with pytest.raises(ValueError, match="contrast"):
        fused_auxiva_ip_iter(X, _identity(5, np.complex128), psum, contrast="cauchy")
    assert CONTRASTS == ("laplace", "gauss")


def test_k2_plain_matches_component_step_f64(rng):
    X = _stereo(rng, 24, 31, np.complex128)
    F = X.shape[1]
    W, _, nlls = _run_plain(torch.as_tensor(X), _identity(F, np.complex128), 5)

    Xj = jnp.asarray(X)
    planes = jip.pair_products_planes(Xj)
    rows = [[jnp.asarray(np.eye(2)[s, c] * np.ones(F, dtype=complex)) for c in range(2)] for s in range(2)]
    Y = jip.separate_components(rows, Xj)
    nlls_ref = []
    for _ in range(5):
        rows, Y, nll = jip.auxiva_ip_step_components(Xj, rows, Y, planes, eps=EPS)
        nlls_ref.append(float(nll))
    np.testing.assert_allclose(nlls, nlls_ref, rtol=1e-9)
    W_ref = np.stack([np.stack([np.asarray(rows[s][c]) for c in range(2)]) for s in range(2)])
    np.testing.assert_allclose(W.numpy(), W_ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_k2_zero_bin_keeps_identity(rng, dtype):
    """An all-zero bin keeps its identity rows exactly and adds 0 to logdet."""
    X = _stereo(rng, 9, 16, dtype)
    X[:, 4] = 0
    Xt = torch.as_tensor(X)
    W0 = _identity(9, dtype)
    psum = torch.sum(torch.abs(Xt) ** 2, dim=1)
    W, _, logdet, _ = fused_auxiva_ip_iter_plain(Xt, W0, psum, eps=EPS)
    np.testing.assert_array_equal(W[:, :, 4].numpy(), np.eye(2, dtype=dtype))
    keep = [f for f in range(9) if f != 4]
    _, _, logdet_rest, _ = fused_auxiva_ip_iter_plain(
        Xt[:, keep].contiguous(), W0[:, :, keep].contiguous(), psum, eps=EPS
    )
    # the zero bin contributes log|det I| = 0; the psum input differs from a
    # run without the bin only by the bin's own zero contribution
    np.testing.assert_allclose(float(logdet), float(logdet_rest), rtol=1e-6 if dtype == np.complex64 else 1e-12)


@pytest.mark.parametrize("T", [7, 469, 6144, 6145, 20_000, 100_000])
def test_k2_launch_plan(T):
    """Every T gets a plan within a Hopper block's shared memory; the slab
    is resident at the main path's T = 469 and up to 2 bins at T = 6145,
    and streamed beyond."""
    plan = k2_launch_plan(2049, T)
    assert plan.smem_bytes + STATIC_SMEM <= SMEM_LIMIT == 232_448
    assert plan.bins % 2 == 0
    assert plan.groups == -(-2049 // plan.bins)
    assert plan.row_stride % 4 == 0 and plan.row_stride >= 2 * T + 1
    assert plan.resident == (T <= 6145)
    if T == 469:
        assert plan.bins == 8
        assert plan.smem_bytes >= 2 * 8 * 8 * T  # both channels' rows of 8 bins
    if T == 6145:
        assert plan.bins == 2
    if not plan.resident:
        assert plan.bins == 8 and plan.smem_bytes <= 8 * 1024  # the staged weights only


def test_k2_launch_plan_rejects_what_does_not_fit():
    """No mixture without bins or frames; the resident slab takes the most
    bins that fit, and streams only where 2 bins do not (T > 6943)."""
    for F, T in [(2049, 0), (0, 469), (-1, 7)]:
        with pytest.raises(ValueError):
            k2_launch_plan(F, T)
    assert [k2_launch_plan(33, T).bins for T in (1700, 1800, 3400, 3500)] == [8, 4, 4, 2]
    assert k2_launch_plan(33, 6943).resident and not k2_launch_plan(33, 6944).resident

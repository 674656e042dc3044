"""The helpers of the port's factorisation models against the JAX package on
the CPU at float64: the divergences, ``algorithm/linalg.py``, the planes and
compact-Hermitian ``fast_linalg`` functions (at n = 1, 2, 3, where the
closed forms branch), ``spatial_covariance`` and the ``ops`` export list."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import audio_source_separation_tpu.algorithm.linalg as jax_linalg
import audio_source_separation_tpu.criterion.divergence as jax_div
import audio_source_separation_tpu.ops as jax_ops
import audio_source_separation_tpu.ops.fast_linalg as jax_fl
import audio_source_separation_tpu_torch.algorithm.linalg as port_linalg
import audio_source_separation_tpu_torch.criterion.divergence as port_div
import audio_source_separation_tpu_torch.ops as port_ops
import audio_source_separation_tpu_torch.ops.fast_linalg as port_fl

from _torch_port import to_np

JAX = SimpleNamespace(fl=jax_fl, linalg=jax_linalg, div=jax_div, ops=jax_ops)
PORT = SimpleNamespace(fl=port_fl, linalg=port_linalg, div=port_div, ops=port_ops)

# names of the JAX ``ops`` package that the port leaves out, and why
DEFERRED_OPS = {
    # the port keeps complex tensors: no real-pair boundary
    "Pair", "jit_complex", "pack", "realify", "to_host", "unpack",
    "auxiva_ip_step_components",  # the port bench's headline step
}  # fmt: skip


def _psd(rng, batch, n, rank=None):
    """Hermitian PSD ``(*batch, n, n)`` matrices, of ``rank`` if given."""
    A = rng.randn(*batch, n, rank or n) + 1j * rng.randn(*batch, n, rank or n)
    return A @ np.conj(np.swapaxes(A, -1, -2)) + (0 if rank else 0.1 * np.eye(n))


def _planes(M):
    """``(..., n, n)`` -> planes ``(n, n, ...)``."""
    return np.ascontiguousarray(np.moveaxis(M, (-2, -1), (0, 1)))


def _close(ours, theirs, rtol=1e-10, atol=1e-12):
    if isinstance(theirs, (tuple, list)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _close(a, b, rtol=rtol, atol=atol)
        return
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs), rtol=rtol, atol=atol)


def same(build, *arrays, **tol):
    """``build(lib, *arrays)`` with ``lib`` the port (on tensors) against the
    JAX package (one jitted program: an eager call compiles op by op)."""
    theirs = jax.jit(lambda *a: build(JAX, *a))(*arrays)
    ours = build(PORT, *(torch.as_tensor(np.array(a)) for a in arrays))
    _close(ours, theirs, **tol)


def _compact(M):
    return np.array(jax.jit(jax_fl.hermitian_compact_from_planes)(_planes(M)))


@pytest.mark.parametrize("name", ["kl_divergence", "is_divergence", "generalized_kl_divergence"])
def test_elementwise_divergences(rng, name):
    same(lambda lib, x, y: getattr(lib.div, name)(x, y), np.abs(rng.randn(3, 5, 7)), np.abs(rng.randn(3, 5, 7)))


def test_beta_divergence(rng):
    x, y = np.abs(rng.randn(5, 7)) + 0.1, np.abs(rng.randn(5, 7)) + 0.1
    same(lambda lib, x, y: [lib.div.beta_divergence(x, y, beta=beta) for beta in (0.5, 2, 3)], x, y)
    for bad in (0, 1):
        with pytest.raises(AssertionError):
            port_div.beta_divergence(torch.as_tensor(x), torch.as_tensor(y), beta=bad)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_matrix_divergences(rng, n):
    """Closed forms at n <= 3, ``torch.linalg`` at 4."""
    x, y = _psd(rng, (4, 5), n), _psd(rng, (4, 5), n)
    same(lambda lib, x, y: [lib.div.multichannel_is_divergence(x, y), lib.div.logdet_divergence(x, y)], x, y, rtol=1e-9)
    with pytest.raises(AssertionError):
        port_div.logdet_divergence(torch.zeros(x.shape[:-1] + (n + 1,)), torch.as_tensor(y))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_eigvalsh(rng, n):
    """``batched_eigvalsh`` (``eigvalsh`` at n = 4), the trailing closed
    forms and the planes form, with exactly diagonal matrices (the
    degenerate branch) among the inputs."""
    A = _psd(rng, (6,), n)
    A[0] = np.diag(np.arange(1.0, n + 1))
    A[1] = 2.0 * np.eye(n)
    same(lambda lib, A: lib.fl.batched_eigvalsh(A), A)
    if n in (2, 3):
        same(lambda lib, A: getattr(lib.fl, "hermitian_eigvalsh_{0}x{0}".format(n))(A), A)
    if n <= 3:
        same(lambda lib, P: lib.fl.hermitian_eigvalsh_planes(P), _planes(A))
    else:
        with pytest.raises(ValueError):
            port_fl.hermitian_eigvalsh_planes(torch.as_tensor(_planes(A)))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_planes_helpers(rng, n):
    A = _planes(rng.randn(4, 5, n, n) + 1j * rng.randn(4, 5, n, n))
    B = _planes(rng.randn(4, 5, n, n) + 1j * rng.randn(4, 5, n, n))

    def build(lib, A, B, s):
        fl = lib.fl
        return [fl.matmul_planes(A, B), fl.herm_planes(A), fl.add_diag_planes(A, s), fl.trace_planes(A)]

    same(build, A, B, rng.rand(4, 5))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_psd_parts_planes(rng, n):
    """The ``to_psd`` projection and its eigenvalues on indefinite,
    non-Hermitian planes (the shift is taken), at two ridges."""
    A = _planes(rng.randn(4, 5, n, n) + 1j * rng.randn(4, 5, n, n))
    same(lambda lib, A: [lib.fl.psd_parts_planes(A), lib.fl.psd_parts_planes(A, eps=1e-3)], A)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_compact_hermitian_helpers(rng, n):
    """Every compact helper, with and without a ridge, against JAX."""
    M, X = _psd(rng, (4, 5), n), _psd(rng, (4, 5), n)

    def build(lib, M, Mc, Xc, small, ridge):
        fl = lib.fl
        return [fl.compact_entry(Mc, c, d) for c in range(n) for d in range(n)] + [
            fl.hermitian_compact_from_planes(M),
            fl.hermitian_compact_from_entries(lambda c, d: M[c, d], n),
            fl.expand_hermitian_compact(Mc),
            fl.expand_hermitian_compact_trailing(small, n),
            fl.det_hermitian_compact(Mc),
            fl.det_hermitian_compact(Mc, ridge=ridge),
            fl.inv_hermitian_compact(Mc),
            fl.inv_hermitian_compact(Mc, ridge=ridge),
            fl.sandwich_hermitian_compact(Mc, Xc),
        ]

    Mc = _compact(M)
    same(build, _planes(M), Mc, _compact(X), np.moveaxis(Mc, 0, -1), rng.rand(4, 5))


def test_compact_closed_forms_refuse_n4(rng):
    planes = torch.as_tensor(_compact(_psd(rng, (3,), 4)))
    for fn in (port_fl.det_hermitian_compact, port_fl.inv_hermitian_compact):
        with pytest.raises(ValueError):
            fn(planes)
    with pytest.raises(ValueError):
        port_fl.power_hermitian_compact(torch.as_tensor(_compact(_psd(rng, (3,), 3))), 0.5)


@pytest.mark.parametrize("rank", [None, 1], ids=["full", "rank1"])
def test_power_and_riccati_compact(rng, rank):
    """The 2 x 2 compact spectral powers, with one exactly scalar matrix
    (the degenerate spectrum); at rank 1 the clipped negative power (the
    square root of a rounding-noise eigenvalue has no reference value), and
    at full rank the compact Riccati solve."""
    A, B = _psd(rng, (4, 5), 2, rank=rank), _psd(rng, (4, 5), 2)
    A[0, 0] = 3.0 * np.eye(2)
    powers = ((-0.5, 1e-12), (1.5, 0.0)) + (((0.5, 0.0),) if rank is None else ())

    def build(lib, Ac, Bc):
        out = [lib.fl.power_hermitian_compact(Ac, power, eps=eps) for power, eps in powers]
        return out + ([lib.fl.solve_riccati_hermitian_compact(Ac, Bc)] if rank is None else [])

    same(build, _compact(A), _compact(B), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_linalg_matches_jax(rng, n):
    """``algorithm/linalg.py``: the 2 x 2 closed form, ``eigh`` otherwise;
    the Riccati solution solves ``H A H = B``."""
    A, B = _psd(rng, (4, 5), n), _psd(rng, (4, 5), n)

    def build(lib, A, B):
        la = lib.linalg
        out = [
            la.sqrtm_hermitian(A),
            la.invsqrtm_hermitian(A),
            la.hermitian_matrix_power(A, -1.5, eps=1e-12),
            la.solve_riccati(A, B),
        ]
        return out + ([la._power_2x2(A, 0.5)] if n == 2 else [])

    same(build, A, B, rtol=1e-8)
    tA = torch.as_tensor(A)
    H = port_linalg.solve_riccati(tA, torch.as_tensor(B))
    _close(H @ tA @ H, B, rtol=1e-8)


def test_spatial_covariance_matches_jax(rng):
    same(lambda lib, X: lib.ops.spatial_covariance(X), rng.randn(3, 7, 20) + 1j * rng.randn(3, 7, 20))


def test_ops_exports_what_jax_exports():
    """The port's ``ops`` exports the JAX ``ops`` names less the deferred
    ones, and each is importable."""
    assert set(port_ops.__all__) == set(jax_ops.__all__) - DEFERRED_OPS
    assert DEFERRED_OPS <= set(jax_ops.__all__)
    from audio_source_separation_tpu_torch.ops import ip_update, spatial_covariance  # noqa: F401

    assert all(callable(getattr(port_ops, name)) for name in port_ops.__all__)

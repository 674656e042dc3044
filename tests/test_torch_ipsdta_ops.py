"""The port's block-PSD ops against the JAX package on the CPU at float64:
``BlockLayout`` at a uniform, a remainder, a padded and the benchmark
geometry; the compact-Hermitian and planes helpers ``models/ipsdta.py``
imports from ``fast_linalg`` (on indefinite and rank-deficient Hermitian
input), ``blockwise_inv`` and ``matmul_small``; the module's PSD-chain
helpers; and the Gauss VCD covariance ``Q`` through K1's wrapper (its plain
version here) against the JAX planes and matrix routes' ``Q``."""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models.ipsdta as jax_ipsdta
from audio_source_separation_tpu.ops import fast_linalg as jax_fl
from audio_source_separation_tpu.ops.blocks import BlockLayout as JaxBlockLayout
from audio_source_separation_tpu.utils.linalg import to_psd as jax_to_psd
import audio_source_separation_tpu_torch.models.ipsdta as port_ipsdta
from audio_source_separation_tpu_torch.ops import BlockLayout, eigh_kernel
from audio_source_separation_tpu_torch.ops import fast_linalg as port_fl
from audio_source_separation_tpu_torch.utils.linalg import to_psd

from _torch_port import to_np
from conftest import make_mixture

GEOMETRIES = [(12, 4), (13, 4), (7, 3), (2049, 1024)]  # uniform, a remainder, padded, the benchmark's
EPS = 1e-12


def _close(ours, theirs, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs), rtol=rtol, atol=atol)


def _hermitian(rng, batch, n, kind):
    """Hermitian ``(*batch, n, n)``: "pd" positive definite, "indefinite",
    "rank1" PSD of rank 1."""
    A = rng.randn(*batch, n, n) + 1j * rng.randn(*batch, n, n)
    if kind == "rank1":
        a = A[..., :, :1]
        return a @ np.conj(np.swapaxes(a, -1, -2))
    H = (A + np.conj(np.swapaxes(A, -1, -2))) / 2
    return H @ H + 0.5 * np.eye(n) if kind == "pd" else H


def _compact(H):
    """Compact real planes ``(n^2, *batch)`` of Hermitian ``H (*batch, n, n)``:
    the diagonal, then (re, im) of each c < d."""
    n = H.shape[-1]
    planes = [H[..., c, c].real for c in range(n)]
    for c in range(n):
        for d in range(c + 1, n):
            planes += [H[..., c, d].real, H[..., c, d].imag]
    return np.ascontiguousarray(np.stack(planes))


# BlockLayout
@pytest.mark.parametrize("n_bins,n_blocks", GEOMETRIES)
def test_block_layout_matches_jax(rng, n_bins, n_blocks):
    ours, ref = BlockLayout(n_bins, n_blocks), JaxBlockLayout(n_bins, n_blocks)
    for name in ("n_neighbors", "n_remains", "block_size"):
        assert getattr(ours, name) == getattr(ref, name)
    for name in ("sizes", "starts", "valid", "gather_index", "scatter_src"):
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(ref, name)))
    nb, B = n_blocks, ref.block_size

    x = rng.randn(3, n_bins) + 1j * rng.randn(3, n_bins)
    _close(ours.gather(torch.as_tensor(x)), ref.gather(x), rtol=0, atol=0)
    _close(ours.gather(torch.as_tensor(x.real)), ref.gather(x.real), rtol=0, atol=0)
    blocked = rng.randn(3, nb, B) + 1j * rng.randn(3, nb, B)  # junk in the padded slots too
    _close(ours.scatter(torch.as_tensor(blocked)), ref.scatter(blocked), rtol=0, atol=0)
    _close(ours.scatter(ours.gather(torch.as_tensor(x))), x, rtol=0, atol=0)
    _close(ours.mask_vector(torch.as_tensor(blocked)), ref.mask_vector(blocked), rtol=0, atol=0)

    M = rng.randn(2, nb, B, B) + 1j * rng.randn(2, nb, B, B)
    for scale in (1.0, 2.5):
        _close(ours.pad_identity(torch.as_tensor(M), scale=scale), ref.pad_identity(M, scale=scale), rtol=0, atol=0)
    _close(ours.zero_padding_matrix(torch.as_tensor(M)), ref.zero_padding_matrix(M), rtol=0, atol=0)


def test_block_layout_caches_its_tables_per_device():
    layout = BlockLayout(13, 4)
    first = layout.tables("cpu")
    assert layout.tables(torch.device("cpu")) is first
    assert all(t.device.type == "cpu" for t in first)
    assert first[0].dtype == torch.int64 and first[1].dtype == torch.bool


# fast_linalg
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["pd", "indefinite", "rank1", "diagonal"])
def test_compact_hermitian_helpers(rng, n, kind):
    H = _hermitian(rng, (4, 5), n, "pd" if kind == "diagonal" else kind)
    if kind == "diagonal":  # the 3 x 3 closed form's degenerate branch (p2 = 0) at a scalar matrix
        H = np.broadcast_to(2.0 * np.eye(n), H.shape).copy()
    P = _compact(H)
    T = torch.as_tensor(P)
    s = rng.rand(4, 5)
    _close(port_fl.trace_hermitian_compact(T), jax_fl.trace_hermitian_compact(P))
    _close(port_fl.add_diag_hermitian_compact(T, torch.as_tensor(s)), jax_fl.add_diag_hermitian_compact(P, s))
    _close(port_fl.square_hermitian_compact(T), jax_fl.square_hermitian_compact(P))
    # a rank-1 3 x 3 matrix has a double eigenvalue 0, where the trigonometric
    # closed form keeps half the digits in both packages: rounding noise of
    # about 1e-8 of the trace there
    eigvals = jax_fl.eigvalsh_hermitian_compact(P)
    atol = 1e-7 * np.abs(eigvals).max() if (kind, n) == ("rank1", 3) else 1e-12
    _close(port_fl.eigvalsh_hermitian_compact(T), eigvals, atol=atol)
    ours, theirs = port_fl.psd_parts_hermitian_compact(T, eps=EPS), jax_fl.psd_parts_hermitian_compact(P, eps=EPS)
    for a, b in zip(ours, theirs):
        _close(a, b, atol=atol)
    if kind != "rank1":  # the inverses of invertible input
        for psd in (True, False):
            _close(port_fl.psd_inv_hermitian_compact(T, eps=EPS, psd=psd),
                   jax_fl.psd_inv_hermitian_compact(P, eps=EPS, psd=psd))  # fmt: skip


@pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
def test_blockwise_inv(rng, n):
    """The Schur form at even n <= 6, ``inv`` at odd n and past 6."""
    A = _hermitian(rng, (3, 4), n, "pd") + 0.3 * rng.randn(3, 4, n, n)
    ours = port_fl.blockwise_inv(torch.as_tensor(A))
    _close(ours, jax_fl.blockwise_inv(A), rtol=1e-9, atol=1e-12)
    _close(ours @ torch.as_tensor(A), np.broadcast_to(np.eye(n), A.shape), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,m", [(2, 2), (3, 3), (3, 1), (4, 4)])
def test_matmul_small(rng, n, m):
    A = rng.randn(5, n, n) + 1j * rng.randn(5, n, n)
    B = rng.randn(5, n, m) + 1j * rng.randn(5, n, m)
    _close(port_fl.matmul_small(torch.as_tensor(A), torch.as_tensor(B)), jax_fl.matmul_small(A, B))


# models/ipsdta.py's PSD chain
@pytest.mark.parametrize("B", [2, 3, 4])
@pytest.mark.parametrize("kind", ["pd", "indefinite", "rank1"])
def test_psd_chain_helpers(rng, B, kind):
    M = _hermitian(rng, (2, 3, 5), B, kind) + 0.01 * (rng.randn(2, 3, 5, B, B) + 1j * rng.randn(2, 3, 5, B, B))
    T = torch.as_tensor(M)
    ours, theirs = port_ipsdta._psd_parts(T), jax_ipsdta._psd_parts(M)
    for a, b in zip(ours, theirs):
        _close(a, b, rtol=1e-9)
    # the inverse of the projection where that is well conditioned, and of
    # the indefinite matrix itself (the projection of an indefinite or rank-1
    # matrix has an eigenvalue of eps trace)
    R = np.array(theirs[0]) if kind == "pd" else M
    if kind != "rank1":
        for psd in (True, False):
            _close(port_ipsdta._psd_inv(torch.as_tensor(R), psd=psd), jax_ipsdta._psd_inv(R, psd=psd), rtol=1e-9)
    _close(port_ipsdta._psd_sqrt_fused(T), jax_ipsdta._psd_sqrt_fused(M), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("n_bins,n_blocks", [(12, 4), (13, 4), (7, 3)])
def test_sqrt_and_invsqrt_after_psd(rng, n_bins, n_blocks):
    """The basis chain's tail on matrices with zero padded rows and columns."""
    ref = JaxBlockLayout(n_bins, n_blocks)
    B = ref.block_size
    C = _hermitian(rng, (2, 3, n_blocks), B, "pd")
    C = np.array(ref.zero_padding_matrix(C))
    pad_diag = (~np.asarray(ref.valid)).astype(float)[..., None] * np.eye(B)
    ours = port_ipsdta._sqrt_and_invsqrt_after_psd(torch.as_tensor(C), torch.as_tensor(pad_diag.astype(complex)))
    theirs = jax_ipsdta._sqrt_and_invsqrt_after_psd(C, pad_diag.astype(complex))
    for a, b in zip(ours, theirs):
        _close(a, b, rtol=1e-9, atol=1e-11)


# the Gauss VCD covariance through K1
@pytest.mark.parametrize("C,n_bins,n_blocks", [(2, 12, 6), (2, 10, 4), (3, 13, 4), (4, 12, 4)])
def test_vcd_covariance_through_k1(rng, monkeypatch, C, n_bins, n_blocks):
    """``Q`` of every source and slot from one call of K1's wrapper with
    per-bin ``(S, F, T)`` weights, against JAX's planes ``_vcd_q_planes``
    and its matrix-route contraction, each then projected."""
    T = 24
    X = make_mixture(rng, n_channels=C, n_bins=n_bins, n_frames=T)
    layout, ref = BlockLayout(n_bins, n_blocks), JaxBlockLayout(n_bins, n_blocks)
    B = layout.block_size
    inv_diag = rng.rand(C, T, n_blocks, B) + 0.1  # (S, T, nb, B), positive like R^-1's diagonal

    calls = []
    wrapper = port_ipsdta.weighted_covariance_planes

    def counted(X_, w):
        assert w.shape == (C, n_bins, T) and w.is_contiguous() and w.dtype == torch.float64
        calls.append(w.shape)
        return wrapper(X_, w)

    monkeypatch.setattr(port_ipsdta, "weighted_covariance_planes", counted)
    solver = port_ipsdta.GaussIPSDTA(n_basis=2, n_blocks=n_blocks, device="cpu")
    Q = solver._vcd_covariances({"input": torch.as_tensor(X)}, layout, torch.as_tensor(inv_diag))
    assert len(calls) == 1 and tuple(Q.shape) == (C, B, C, C, n_blocks)

    # the JAX planes route (C <= 3): one (C, C, nb) per source and slot
    Xg = np.asarray(ref.gather(np.transpose(X, (0, 2, 1))))  # (C, T, nb, B)
    XP = np.transpose(Xg, (3, 0, 1, 2))
    for n in range(C if C <= 3 else 0):
        for j in range(B):
            expected = jax_ipsdta.GaussIPSDTA._vcd_q_planes(inv_diag[n, :, :, j], XP[j], T, C, EPS)
            _close(port_ipsdta._to_psd_planes(Q[n, j]), expected, rtol=1e-10, atol=1e-13)
    # the JAX matrix route: (B, nb, C, C) per source
    Xb = np.transpose(Xg, (1, 2, 3, 0))  # (T, nb, B, C)
    XX = Xb[..., :, None] * Xb[..., None, :].conj()
    for n in range(C):
        expected = jax_to_psd(np.einsum("tbj,tbjcd->jbcd", inv_diag[n], XX) / T, eps=EPS)
        _close(to_psd(Q[n].permute(0, 3, 1, 2)), expected, rtol=1e-10, atol=1e-13)


def test_eigh_wide_chunks_and_gives_nan_for_non_finite_blocks(rng, monkeypatch):
    """The IPSDTA eigensolves (K3, ``ops/eigh_kernel.py::batched_eigh``;
    its plain version here) split the batch into chunks (cuSOLVER refuses
    large batches) with ``torch.linalg.eigh``'s result at complex128, and
    give NaN for a block holding a non-finite entry, as JAX's ``eigh`` does,
    where ``torch.linalg.eigh`` raises."""
    monkeypatch.setattr(eigh_kernel, "EIGH_CHUNK", 4)
    H = torch.as_tensor(_hermitian(rng, (3, 5), 4, "indefinite").astype(np.complex64))
    w, v = eigh_kernel.batched_eigh(H)
    w_ref, v_ref = torch.linalg.eigh(H.to(torch.complex128))
    assert w.dtype == torch.float32 and v.dtype == torch.complex64
    _close(w, w_ref.numpy(), rtol=1e-6, atol=1e-6)
    _close(v @ torch.diag_embed(w.to(v.dtype)) @ v.mH, H.numpy(), rtol=1e-5, atol=1e-5)
    _close(eigh_kernel.batched_eigh(H, vectors=False), w_ref.numpy(), rtol=1e-6, atol=1e-6)

    H[1, 2, 0, 3] = float("nan")
    w, v = eigh_kernel.batched_eigh(H)
    assert torch.isnan(w[1, 2]).all() and torch.isnan(v[1, 2]).all()
    finite = torch.ones(3, 5, dtype=torch.bool)
    finite[1, 2] = False
    assert torch.isfinite(w[finite]).all() and torch.isfinite(v[finite]).all()
    assert torch.isnan(eigh_kernel.batched_eigh(H, vectors=False)[1, 2]).all()

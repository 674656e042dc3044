"""The port's cost model (``runtime/cost_model.py``) and ``scan_cost_analysis``
(``runtime/profiling.py``) on the CPU: one test for each counting rule, the
kernels' charges against ``k1_cost`` / ``k2_cost`` and chip_smoke's
formulas, every solver class of ``models.__all__``, and the JAX package's
host draws around its own ``scan_cost_analysis``."""

import math
import types
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import audio_source_separation_tpu as jax_pkg
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu.runtime import scan_cost_analysis as jax_scan_cost_analysis
from audio_source_separation_tpu_torch import models
from audio_source_separation_tpu_torch.ops.cov_kernel import (
    k1_cost,
    weighted_covariance_planes,
    weighted_covariance_planes_plain,
)
from audio_source_separation_tpu_torch.ops.eigh_kernel import batched_eigh, eigh_cost
from audio_source_separation_tpu_torch.ops.fused_ip import fused_auxiva_ip_iter, k2_cost
from audio_source_separation_tpu_torch.runtime import scan_cost_analysis
from audio_source_separation_tpu_torch.runtime.cost_model import CostCounter, active_counter
from audio_source_separation_tpu_torch.runtime.profiling import iteration_cost
from audio_source_separation_tpu_torch.runtime.solver import IterativeSolver

from conftest import make_mixture

C, F, T = 2, 65, 40
REAL, COMPLEX = torch.float64, torch.complex128


def count(fn):
    """The counter of one call of ``fn``."""
    counter = CostCounter()
    with counter:
        fn()
    return counter


def costly(counter):
    """The ops that counted bytes or FLOPs."""
    return [name for name, (_, n_bytes, flops) in counter.by_op.items() if n_bytes or flops]


def randn(*shape, dtype=REAL):
    return torch.randn(*shape, dtype=dtype, generator=torch.Generator().manual_seed(sum(shape)))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------- #
# the rules, one op each
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [REAL, COMPLEX], ids=["real", "complex"])
@pytest.mark.parametrize("batch", [(), (2,)], ids=["mm", "bmm"])
def test_matmul_family_counts_flop_counter_formula(batch, dtype):
    """``mm`` and ``bmm``: the operands and the product once each, ``2 m n k``
    FLOPs a matrix, times 4 at a complex type."""
    a, b = randn(*batch, 3, 4, dtype=dtype), randn(*batch, 4, 5, dtype=dtype)
    counter = count(lambda: a @ b)
    assert costly(counter) == ["aten.bmm" if batch else "aten.mm"]
    assert counter.bytes == nbytes(a, b) + nbytes(randn(*batch, 3, 5, dtype=dtype))
    assert counter.flops == math.prod(batch) * 2 * 3 * 4 * 5 * (4 if dtype.is_complex else 1)


def test_addmm_counts_the_product():
    bias, a, b = randn(5), randn(3, 4), randn(4, 5)
    counter = count(lambda: torch.addmm(bias, a, b))
    assert counter.bytes == nbytes(bias, a, b) + 3 * 5 * 8
    assert counter.flops == 2 * 3 * 4 * 5


def test_conjugate_operand_is_read_in_place():
    """``a^H b``: ``transpose`` and ``_conj`` are free, ``mm`` reads the
    conjugate view without a copy."""
    a, b = randn(4, 3, dtype=COMPLEX), randn(4, 5, dtype=COMPLEX)
    counter = count(lambda: a.mH @ b)
    assert counter.by_op["aten._conj"][1:] == [0, 0.0] and "aten.clone" not in counter.by_op
    assert counter.bytes == nbytes(a, b) + 3 * 5 * 16 and counter.flops == 4 * 2 * 3 * 4 * 5


@pytest.mark.parametrize("dtype", [REAL, COMPLEX], ids=["real", "complex"])
def test_elementwise_counts_one_flop_a_real_element(dtype):
    a, b = randn(3, 4, dtype=dtype), randn(3, 4, dtype=dtype)
    counter = count(lambda: a * b)
    assert counter.bytes == 3 * nbytes(a)
    assert counter.flops == 12 * (2 if dtype.is_complex else 1)


def test_distinct_inputs_count_once():
    a = randn(3, 4)
    assert count(lambda: a * a).bytes == 2 * nbytes(a)


def test_broadcast_input_counts_its_distinct_elements():
    """A stride-0 (expanded) input is read at its 4 distinct elements, not
    its 12 logical ones."""
    row, b = randn(1, 4), randn(3, 4)
    expanded = row.expand(3, 4)
    counter = count(lambda: torch.mul(expanded, b))
    assert counter.bytes == 4 * 8 + 12 * 8 + 12 * 8 and counter.flops == 12


@pytest.mark.parametrize("dtype", [REAL, COMPLEX], ids=["real", "complex"])
def test_reduction_counts_its_input_elements(dtype):
    a = randn(3, 4, dtype=dtype)
    counter = count(lambda: a.sum(dim=1))
    assert counter.bytes == nbytes(a) + 3 * a.element_size()
    assert counter.flops == 12 * (2 if dtype.is_complex else 1)


VIEWS = {
    "view": lambda a: a.view(4, 3),
    "reshape": lambda a: a.reshape(12),
    "expand": lambda a: a[:1].expand(5, 4),
    "transpose": lambda a: a.transpose(0, 1),
    "permute": lambda a: a.permute(1, 0),
    "select": lambda a: a[1],
    "slice": lambda a: a[:, 1:3],
    "unsqueeze": lambda a: a.unsqueeze(0),
    "as_strided": lambda a: a.as_strided((2, 2), (1, 1)),
    "conj": lambda a: a.conj(),
    "view_as_real": lambda a: torch.view_as_real(a),
    "real": lambda a: a.real,
    "detach": lambda a: a.detach(),
    "alias": lambda a: torch.ops.aten.alias(a),
    "unbind": lambda a: a.unbind(0),
    "transpose_": lambda a: a.transpose_(0, 1),
    "item": lambda a: a[0, 0].item(),
    "empty": lambda a: torch.empty(3, 4),
    "empty_like": lambda a: torch.empty_like(a),
}


@pytest.mark.parametrize("name", sorted(VIEWS))
def test_views_and_aliases_count_nothing(name):
    a = randn(3, 4, dtype=COMPLEX)
    counter = count(lambda: VIEWS[name](a))
    assert counter.by_op and counter.bytes == 0 and counter.flops == 0


def test_in_place_op_counts_its_read_and_write():
    a, b = randn(3, 4), randn(3, 4)
    counter = count(lambda: a.add_(b))
    assert list(counter.by_op) == ["aten.add_"]
    assert counter.bytes == 3 * nbytes(a) and counter.flops == 12


def test_out_argument_is_only_written():
    a, b, out = randn(3, 4), randn(3, 4), torch.zeros(3, 4, dtype=REAL)
    counter = count(lambda: torch.add(a, b, out=out))
    assert counter.bytes == 3 * nbytes(a) and counter.flops == 12


MATERIALISING = {
    "clone": (REAL, lambda a, b: a.clone()),
    "contiguous": (REAL, lambda a, b: a.t().contiguous()),
    "resolve_conj": (COMPLEX, lambda a, b: a.conj().resolve_conj()),
    "copy_": (REAL, lambda a, b: a.copy_(b)),
    "to": (REAL, lambda a, b: a.to(torch.float32)),
}


@pytest.mark.parametrize("name", sorted(MATERIALISING))
def test_materialising_ops_count_read_and_write(name):
    """A copy reads its source and writes its result in full, and does no
    arithmetic."""
    dtype, fn = MATERIALISING[name]
    a, b = randn(3, 4, dtype=dtype), randn(3, 4, dtype=dtype)
    counter = count(lambda: fn(a, b))
    written = 12 * (4 if name == "to" else a.element_size())
    assert counter.bytes == nbytes(a) + written and counter.flops == 0


def test_fill_and_zero_only_write():
    a = randn(3, 4)
    assert (count(lambda: a.zero_()).bytes, count(lambda: a.fill_(2.0)).bytes) == (nbytes(a), nbytes(a))
    assert count(lambda: a.zero_()).flops == 0


def _spd(dtype, batch=3, n=4):
    A = randn(batch, n, n, dtype=dtype)
    return A @ A.mH + n * torch.eye(n, dtype=dtype)


# name, call, FLOPs of one matrix: order n = 4 with k = 2 right-hand sides,
# and for the SVDs a tall m x n = 4 x 3 one.  Under the counting mode
# PyTorch's eigvalsh and svdvals compute the vectors too (their
# differentiable route; svdvals' thin ones), and that is what is counted.
SVD_THIN = 14 * 4 * 3**2 + 8 * 3**3
LINALG = {
    "inv": (torch.linalg.inv, 2 * 4**3),
    "solve": (lambda A: torch.linalg.solve(A, A[..., :2]), 2 / 3 * 4**3 + 2 * 4**2 * 2),
    "cholesky": (torch.linalg.cholesky, 4**3 / 3),
    "eigh": (torch.linalg.eigh, 9 * 4**3),
    "eigvalsh": (torch.linalg.eigvalsh, 9 * 4**3),
    "det": (torch.linalg.det, 2 / 3 * 4**3),
    "slogdet": (torch.linalg.slogdet, 2 / 3 * 4**3),
    "lu_factor": (torch.linalg.lu_factor, 2 / 3 * 4**3),
    "solve_triangular": (lambda A: torch.linalg.solve_triangular(A.tril(), A[..., :2], upper=False), 4**2 * 2),
    "svd": (lambda A: torch.linalg.svd(A[..., :3]), 4 * 4**2 * 3 + 8 * 4 * 3**2 + 9 * 3**3),
    "svd_thin": (lambda A: torch.linalg.svd(A[..., :3], full_matrices=False), SVD_THIN),
    "svdvals": (lambda A: torch.linalg.svdvals(A[..., :3]), SVD_THIN),
}


@pytest.mark.parametrize("dtype", [REAL, COMPLEX], ids=["real", "complex"])
@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg_dense_counts(name, dtype):
    """Each ``torch.linalg`` function's op: its dense count a matrix times
    the batch of 3, times 4 at a complex type (the ``tril`` of
    ``solve_triangular``'s operand is data movement)."""
    fn, per = LINALG[name]
    A = _spd(dtype)
    counter = count(lambda: fn(A))
    assert counter.flops == pytest.approx(3 * per * (4 if dtype.is_complex else 1), rel=1e-12)
    assert counter.bytes >= nbytes(A)


@pytest.mark.parametrize("name", ["rfft", "fft", "irfft"])
def test_fft_counts_five_n_log_n(name):
    """``5 n log2 n`` a complex transform of ``n = 16`` points, half a real
    one, over 3 rows."""
    x = randn(3, 16, dtype=COMPLEX if name == "fft" else REAL)
    fn = {
        "rfft": lambda: torch.fft.rfft(x, dim=-1),
        "fft": lambda: torch.fft.fft(x, dim=-1),
        "irfft": lambda: torch.fft.irfft(torch.fft.rfft(x, dim=-1), n=16, dim=-1),
    }[name]
    counter = count(fn)
    per = 5 * 16 * 4 * (1 if name == "fft" else 0.5)
    assert counter.flops == 3 * per * (2 if name == "irfft" else 1)


# --------------------------------------------------------------------------- #
# the kernels' charges
# --------------------------------------------------------------------------- #
# chip_smoke.py's kernel phase: (C, F, T, N, per_bin) -> (bytes, FLOPs) of its
# bound, K1's X once (complex64), the weights once and the planes once (float32)
K1_PHASE2 = {
    (2, 2049, 469, 2, False): (15445016, 26907468),
    (3, 2049, 469, 3, False): (23290464, 77839461),
    (4, 2049, 469, 4, False): (31283440, 169132656),
    (4, 65, 16384, 4, False): (34357504, 187432960),
    (3, 513, 7501, 3, False): (92497728, 311689053),
    (3, 2049, 469, 2, False): (23214824, 60541803),
    (5, 2049, 469, 5, False): (39473120, 312318825),
    (1, 2049, 469, 1, False): (7697920, 4804905),
    (2, 2049, 469, 2, True): (23129112, 26907468),
    (3, 2049, 469, 3, True): (34816608, 77839461),
    (3, 2049, 469, 2, True): (30898920, 60541803),
    (5, 2049, 469, 5, True): (58683360, 312318825),
    (2, 513, 7501, 2, True): (92368728, 107744364),
    (3, 129, 7001, 3, True): (32526576, 73153449),
}
# (F, T) -> (bytes, FLOPs): X once, W and psum in and out, logdet and the NLL
K2_PHASE2 = {(2049, 469): (15514344, 59580822), (257, 9000): (37168456, 143406000), (1025, 469): (7764712, 29804950)}


@pytest.mark.parametrize("case", sorted(K1_PHASE2), ids=str)
def test_k1_cost_is_chip_smokes_bound(case):
    C_, F_, T_, N, per_bin = case
    assert k1_cost(C_, N, F_, T_, per_bin, 8, 4) == K1_PHASE2[case]


@pytest.mark.parametrize("case", sorted(K2_PHASE2), ids=str)
def test_k2_cost_is_chip_smokes_bound(case):
    assert k2_cost(*case, 8) == K2_PHASE2[case]


@pytest.mark.parametrize("dtype", [torch.complex64, COMPLEX], ids=["c64", "c128"])
@pytest.mark.parametrize("per_bin", [False, True], ids=["nt", "nft"])
def test_k1_call_charges_k1_cost_only(per_bin, dtype):
    """One K1 call on the CPU charges ``k1_cost`` once and none of its plain
    route's ops."""
    X = torch.as_tensor(make_mixture(np.random.RandomState(1), 3, F, T)).to(dtype)
    w = randn(*((2, F, T) if per_bin else (2, T)), dtype=X.real.dtype).abs() + 0.1
    counter = count(lambda: weighted_covariance_planes(X, w))
    n_bytes, flops = k1_cost(3, 2, F, T, per_bin, X.element_size(), w.element_size())
    assert counter.charges == {"K1": 1} and list(counter.by_op) == ["kernel:K1"]
    assert (counter.bytes, counter.flops) == (n_bytes, flops)


@pytest.mark.parametrize("contrast", ["laplace", "gauss"])
def test_k2_call_charges_k2_cost_only(contrast):
    X = torch.as_tensor(make_mixture(np.random.RandomState(2), 2, F, T))
    W = torch.eye(2, dtype=COMPLEX)[:, :, None].repeat(1, 1, F)
    psum = torch.sum(X.abs() ** 2, dim=1)
    counter = count(lambda: fused_auxiva_ip_iter(X, W, psum, contrast=contrast))
    assert counter.charges == {"K2": 1} and list(counter.by_op) == ["kernel:K2"]
    assert (counter.bytes, counter.flops) == k2_cost(F, T, 16)


@pytest.mark.parametrize("dtype", [torch.float32, REAL, torch.complex64, COMPLEX], ids=["f32", "f64", "c64", "c128"])
@pytest.mark.parametrize("vectors", [True, False], ids=["vectors", "values"])
def test_k3_call_charges_eigh_cost_only(dtype, vectors):
    """One K3 call on the CPU charges ``eigh_cost`` once and none of its
    plain route's ops (``torch.linalg.eigh`` at double precision)."""
    A = randn(5, 3, 6, 6, dtype=COMPLEX if dtype.is_complex else REAL)
    H = (A + A.mH).to(dtype)
    counter = count(lambda: batched_eigh(H, vectors=vectors))
    assert counter.charges == {"K3": 1} and list(counter.by_op) == ["kernel:K3"]
    assert (counter.bytes, counter.flops) == eigh_cost(6, 15, dtype.is_complex, vectors, H.element_size())


# the families whose step eigensolves, their input and K3's calls an iteration
K3_FAMILIES = {
    "LDPSDTF(2)": (lambda: port.LDPSDTF(n_basis=2, device="cpu"), "gram", 2),  # the basis step, the pencil
    "LDPSDTF(3)": (lambda: port.LDPSDTF(n_basis=3, device="cpu"), "gram3", 3),  # the basis step, two models
    "CovarianceISNMF C = 3": (lambda: port.CovarianceISNMF(n_basis=2, device="cpu"), "covariance3", 3),  # Riccati
    "Sawada C = 3": (lambda: port.MultichannelISNMF(n_basis=2, device="cpu"), "X3", 3),
}


@pytest.mark.parametrize("name", sorted(K3_FAMILIES))
def test_eigensolving_families_charge_k3(name):
    """Every eigensolve of these steps is a K3 charge: no ``torch.linalg``
    eigensolver op is counted, and the charges' bytes and FLOPs are in the
    iteration's."""
    make, key, calls = K3_FAMILIES[name]
    rng = np.random.RandomState(8)
    X3 = make_mixture(rng, 3, F, T)
    inputs = dict(_inputs(), X3=X3, gram3=_gram(3), covariance3=np.einsum("cft,dft->ftcd", X3, X3.conj()))
    np.random.seed(111)
    counter = iteration_cost(make(), inputs[key])
    assert counter.charges == {"K3": calls}
    assert not any("eigh" in op or "svd" in op for op in counter.by_op)
    n, n_bytes, flops = counter.by_op["kernel:K3"]
    assert n == calls and 0 < n_bytes < counter.bytes and 0 < flops < counter.flops


def test_block_psd_charges_k3_past_three():
    """GaussIPSDTA at B > 3: the blocks' eigensolves are K3 charges beside
    K1's (at B <= 3 the closed forms leave only the square-root chain's)."""
    np.random.seed(111)
    counter = iteration_cost(port.GaussIPSDTA(n_basis=2, n_blocks=4, device="cpu"), _inputs()["X"])
    assert counter.charges["K1"] == 1 and counter.charges["K3"] >= 2
    assert not any("eigh" in op for op in counter.by_op)


def test_failed_kernel_call_raises_and_charges_nothing():
    X = torch.as_tensor(make_mixture(np.random.RandomState(2), 2, F, T))
    W = torch.eye(2, dtype=COMPLEX)[:, :, None].repeat(1, 1, F)
    psum = torch.ones(2, T, dtype=REAL)
    counter = CostCounter()
    with pytest.raises(ValueError, match="contrast"), counter:
        fused_auxiva_ip_iter(X, W, psum, contrast="cauchy")
    assert counter.charges == {} and counter.bytes == 0


def test_wrappers_outside_a_count_run_as_before():
    """With no count in force, a wrapper runs its route unchanged; inside
    one, it returns the same values."""
    X = torch.as_tensor(make_mixture(np.random.RandomState(3), 2, F, T))
    w = randn(2, T).abs()
    assert active_counter() is None
    outside = weighted_covariance_planes(X, w)
    assert torch.equal(outside, weighted_covariance_planes_plain(X, w))
    counter = CostCounter()
    with counter:
        assert active_counter() is counter
        inside = weighted_covariance_planes(X, w)
    assert torch.equal(inside, outside)


# --------------------------------------------------------------------------- #
# scan_cost_analysis on the solvers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cls", [port.AuxLaplaceIVA, port.AuxGaussIVA], ids=["laplace", "gauss"])
def test_auxiva_ip_c2_iteration_is_one_k2_charge(cls):
    """AuxIVA IP at C = 2: one iteration is K2's charge and nothing else,
    since ``update_state`` calls K2 and only repacks its outputs into the
    state dict (the NLL is K2's own output)."""
    counter = iteration_cost(cls(device="cpu"), make_mixture(np.random.RandomState(4), C, F, T))
    assert counter.charges == {"K2": 1} and list(counter.by_op) == ["kernel:K2"]
    assert (counter.bytes, counter.flops) == k2_cost(F, T, 16)


def _gram(n_basis, taps=8, n_frames=T):
    rng = np.random.RandomState(7)
    bases = np.stack([a @ a.T + 0.5 * np.eye(taps) for a in rng.randn(n_basis, taps, taps)])
    return np.einsum("kij,kt->ijt", bases, np.abs(rng.randn(n_basis, n_frames)) + 0.2)


class _Network(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = torch.nn.Linear(F, F, dtype=REAL)

    def forward(self, amplitude):
        return torch.nn.functional.softplus(self.linear(amplitude.transpose(1, 2))).transpose(1, 2)


def _idlma():
    torch.manual_seed(0)
    solver = port.GaussIDLMA(device="cpu")
    solver.dnn = port.torch_dnn(_Network())
    return solver


def _inputs():
    rng = np.random.RandomState(6)
    X = make_mixture(rng, C, F, T)
    return {
        "X": X, "X4": make_mixture(rng, 4, F, T), "power": np.abs(X[0]) ** 2, "spectrogram": X[0],
        "power_tensor": np.abs(X) ** 2, "covariance": np.einsum("cft,dft->ftcd", X, X.conj()), "gram": _gram(2),
    }


# every iterative solver class of models.__all__: a factory and its input
SOLVERS = {
    "GradLaplaceIVA": (lambda: port.GradLaplaceIVA(device="cpu"), "X"),
    "NaturalGradLaplaceIVA": (lambda: port.NaturalGradLaplaceIVA(device="cpu"), "X"),
    "AuxLaplaceIVA": (lambda: port.AuxLaplaceIVA(device="cpu"), "X"),
    "AuxGaussIVA": (lambda: port.AuxGaussIVA(device="cpu"), "X"),
    "OverAuxLaplaceIVA": (lambda: port.OverAuxLaplaceIVA("IP", n_sources=2, device="cpu"), "X4"),
    "EUCNMF": (lambda: port.EUCNMF(device="cpu"), "power"),
    "KLNMF": (lambda: port.KLNMF(device="cpu"), "power"),
    "ISNMF": (lambda: port.ISNMF(device="cpu"), "power"),
    "TNMF": (lambda: port.TNMF(device="cpu"), "power"),
    "tNMF": (lambda: port.tNMF(device="cpu"), "power"),
    "CauchyNMF": (lambda: port.CauchyNMF(device="cpu"), "power"),
    "ComplexEUCNMF": (lambda: port.ComplexEUCNMF(device="cpu"), "spectrogram"),
    "CovarianceISNMF": (lambda: port.CovarianceISNMF(n_basis=2, device="cpu"), "covariance"),
    "EUCNTF": (lambda: port.EUCNTF(device="cpu"), "power_tensor"),
    "GaussILRMA": (lambda: port.GaussILRMA(n_basis=2, device="cpu"), "X"),
    "TILRMA": (lambda: port.TILRMA(n_basis=2, device="cpu"), "X"),
    "tILRMA": (lambda: port.tILRMA(n_basis=2, device="cpu"), "X"),
    "ConsistentGaussILRMA": (lambda: port.ConsistentGaussILRMA(n_basis=2, fft_size=128, device="cpu"), "X"),
    "GradLaplaceFDICA": (lambda: port.GradLaplaceFDICA(device="cpu"), "X"),
    "NaturalGradLaplaceFDICA": (lambda: port.NaturalGradLaplaceFDICA(device="cpu"), "X"),
    "ProxLaplaceIVA": (lambda: port.ProxLaplaceIVA(device="cpu"), "X"),
    "MultichannelISNMF": (lambda: port.MultichannelISNMF(n_basis=2, device="cpu"), "X"),
    "FastMultichannelISNMF": (lambda: port.FastMultichannelISNMF(n_basis=2, device="cpu"), "X"),
    "GaussIDLMA": (_idlma, "X"),
    "GaussIPSDTA": (lambda: port.GaussIPSDTA(n_basis=2, device="cpu"), "X"),
    "TIPSDTA": (lambda: port.TIPSDTA(n_basis=2, device="cpu"), "X"),
    "tIPSDTA": (lambda: port.tIPSDTA(n_basis=2, device="cpu"), "X"),
    "LDPSDTF": (lambda: port.LDPSDTF(n_basis=2, device="cpu"), "gram"),
}
# classes whose constructor raises: the reference's stubs, no iteration to count
STUBS = {"SparseAuxIVA", "GGDILRMA", "KLILRMA", "RegularizedILRMA", "SparseProxIVA"}
# constructible classes whose update raises, as the reference's do: the
# MultichanneltNMF stub and the primal-dual base without a penalty
UNIMPLEMENTED = {"MultichanneltNMF", "PDSBSSBase"}
# not iterative: one call, no iteration
ONE_SHOT = {"DelaySumBeamformer", "MVDRBeamformer", "MaxSNRBeamformer"}


def test_every_solver_class_is_covered():
    classes = {name for name in models.__all__ if isinstance(getattr(models, name), type)}
    assert classes == set(SOLVERS) | STUBS | UNIMPLEMENTED | ONE_SHOT
    assert not any(issubclass(getattr(models, name), IterativeSolver) for name in ONE_SHOT)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_scan_cost_analysis_is_positive_and_finite(name):
    make, key = SOLVERS[name]
    np.random.seed(111)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the "in progress" warnings of ILRMA ISS and Ozerov
        result = scan_cost_analysis(make(), _inputs()[key])
    assert all(type(v) is float and math.isfinite(v) and v > 0 for v in result), result


@pytest.mark.parametrize("name", sorted(STUBS | UNIMPLEMENTED))
def test_unimplemented_solvers_raise(name):
    with warnings.catch_warnings(), pytest.raises(NotImplementedError):
        warnings.simplefilter("ignore", UserWarning)
        scan_cost_analysis(getattr(models, name)(device="cpu"), _inputs()["X"])


def test_one_shot_beamformer_raises():
    with pytest.raises(TypeError, match="IterativeSolver"):
        scan_cost_analysis(port.MVDRBeamformer(device="cpu"), _inputs()["X"])


def test_without_a_card_a_cuda_solver_raises(monkeypatch):
    solver = port.AuxLaplaceIVA(device="cpu")
    solver.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scan_cost_analysis(solver, _inputs()["X"])


def test_update_fn_is_honoured_and_iteration_short_ignored():
    X = _inputs()["X"]
    solver = port.AuxLaplaceIVA(device="cpu")
    counter = iteration_cost(solver, X, update_fn=lambda state: state["input"].abs())
    assert list(counter.by_op) == ["aten.abs"]
    assert (counter.bytes, counter.flops) == (C * F * T * (16 + 8), 2 * C * F * T)
    assert scan_cost_analysis(solver, X, iteration=7, short=3) == scan_cost_analysis(solver, X)


@pytest.mark.parametrize("name", ["AuxLaplaceIVA", "GaussILRMA", "FastMultichannelISNMF", "GaussIPSDTA"])
def test_solver_stays_usable(name):
    """After a count the solver's attributes are as before, and its call
    gives what a fresh solver's gives from the same draws."""
    make, key = SOLVERS[name]
    X = _inputs()[key]
    solver = make()
    attributes = dict(vars(solver))
    np.random.seed(111)
    scan_cost_analysis(solver, X)
    assert vars(solver) == attributes
    outputs = []
    for s in (solver, make()):
        np.random.seed(5)
        outputs.append((s(X, iteration=2), s.loss))
    assert torch.equal(outputs[0][0], outputs[1][0]) and outputs[0][1] == outputs[1][1]


def test_callers_tensor_is_not_updated():
    X = torch.as_tensor(_inputs()["X"])
    before = X.clone()
    scan_cost_analysis(port.AuxLaplaceIVA(algorithm_spatial="ISS", device="cpu"), X)
    assert torch.equal(X, before)


@pytest.mark.parametrize("name", ["AuxLaplaceIVA", "GaussILRMA", "FastMultichannelISNMF"])
def test_host_draws_match_jax_scan_cost_analysis(name):
    """The next ``np.random`` draw after each package's
    ``scan_cost_analysis`` from seed 111 is the same: both draw the init
    once, as their calls do."""
    X = _inputs()["X"]
    kwargs = {} if name == "AuxLaplaceIVA" else {"n_basis": 2}
    draws = []
    for solver, analyse in [
        (getattr(jax_pkg.models, name)(**kwargs), jax_scan_cost_analysis),
        (getattr(port, name)(device="cpu", **kwargs), scan_cost_analysis),
    ]:
        np.random.seed(111)
        bytes_, flops = analyse(solver, X)
        assert bytes_ > 0 and flops > 0
        draws.append(np.random.rand(4))
    np.testing.assert_array_equal(draws[0], draws[1])


@pytest.mark.parametrize("mode", ["bins", "frames"])
def test_use_mesh_counts_the_unsharded_iteration_as_jax_does(mode):
    """Under ``use_mesh`` both packages count the whole unsharded iteration
    on one device: JAX's count on a 2-device CPU mesh equals its count
    without one, and the port's likewise (its mesh is never entered, so a
    stand-in with the dimension names is enough)."""
    X = _inputs()["X"]

    def counts(make, analyse, mesh):
        solver = make()
        if mesh is not None:
            solver.use_mesh(mesh, mode=mode)
        return analyse(solver, X)

    jax_mesh = Mesh(np.array(jax.devices()[:2]), ("bins",))
    make_jax = jax_pkg.models.AuxLaplaceIVA
    assert counts(make_jax, jax_scan_cost_analysis, None) == counts(make_jax, jax_scan_cost_analysis, jax_mesh)
    stand_in = types.SimpleNamespace(mesh_dim_names=("bins",))
    make_port = lambda: port.GaussILRMA(n_basis=2, device="cpu")  # noqa: E731
    assert counts(make_port, scan_cost_analysis, None) == counts(make_port, scan_cost_analysis, stand_in)

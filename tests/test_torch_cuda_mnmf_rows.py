"""Kernel K4 (``csrc/fastmnmf_rows.cu``, ``ops/mnmf_rows.py``) on the card.

K4 against its plain version at C = 2, 3, 4, complex64 and complex128,
with and without the power normalisation, under the guards ``one_norm``
and ``none``: to rounding, with NaN exactly where the plain version has
it, bins planted so the guard fails keeping their rows, a bin whose
``qVq`` reaches the ``eps`` floor; bit-identical launches, one counted a
call; the raises on operands the kernel does not take; and FastMNMF's
captured loop bit for bit against its eager loop with K4 in both, one K4
launch an iteration on each.

Needs an NVIDIA GPU with ``nvcc``; each test skips without one.  This file
imports neither JAX nor ``conftest``:

    python -m pytest tests/test_torch_cuda_mnmf_rows.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

from audio_source_separation_tpu_torch import FastMultichannelISNMF
from audio_source_separation_tpu_torch.ops.ip_components import _covariance_planes, pair_products_planes
from audio_source_separation_tpu_torch.ops.mnmf_rows import fastmnmf_rows, fastmnmf_rows_plain
from audio_source_separation_tpu_torch.utils.flooring import EPS, THRESHOLD

pytestmark = pytest.mark.cuda

F, T, S, K = 513, 64, 2, 10
# bins planted for the guard: a zero covariance and a zero diagonaliser
# (NaN condition numbers); at complex128 one whose covariance is 1e30 times
# the rest, so that qVq (about 1e-30) reaches the eps floor
ZERO_U, ZERO_Q, HUGE_U = 3, 7, 11
DTYPES = {"c64": torch.complex64, "c128": torch.complex128}
# K4 against the plain version, relative to each output's largest entry:
# float32 rounding through a 4 x 4 adjugate and the sequential sweep
RTOL = {torch.complex64: 2e-5, torch.complex128: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(C, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    X = torch.complex(randn(C, F, T), randn(C, F, T)).to(dtype)
    weights = (10 ** (3 * torch.rand((C, F, T), generator=gen, device=device) - 1.5)).to(real)
    U = _covariance_planes(pair_products_planes(X), weights).contiguous()
    Q = (torch.eye(C, device=device) + 0.3 * torch.complex(randn(F, C, C), randn(F, C, C))).to(dtype).contiguous()
    U[:, ZERO_U] = 0
    if dtype == torch.complex128:
        U[:, HUGE_U] *= 1e30
    Q[ZERO_Q] = 0
    g = torch.rand((S, F, C), generator=gen, device=device).to(real)
    W = torch.rand((S, F, K), generator=gen, device=device).to(real)
    return U, Q, g, W


def _close(a, b, rtol):
    """NaN exactly where ``b`` has it; elsewhere within ``rtol`` of ``b``'s
    largest entry."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    finite = torch.isfinite(b)
    assert torch.equal(finite, torch.isfinite(a))
    if finite.any():
        err = float((a - b).abs()[finite].max() / b.abs()[finite].max())
        assert err <= rtol, err


@pytest.mark.parametrize("normalize", [True, False], ids=["power", "plain"])
@pytest.mark.parametrize("guard", ["one_norm", "none"])
@pytest.mark.parametrize("C", [2, 3, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k4_matches_its_plain_version(cuda, dtype, C, guard, normalize):
    dt = DTYPES[dtype]
    U, Q, g, W = _operands(C, dt, cuda, seed=C)
    before = fastmnmf_rows.launches
    got = fastmnmf_rows(U, Q, g, W, EPS, THRESHOLD, guard=guard, normalize=normalize)
    again = fastmnmf_rows(U, Q, g, W, EPS, THRESHOLD, guard=guard, normalize=normalize)
    ref = fastmnmf_rows_plain(U, Q, g, W, EPS, THRESHOLD, guard=guard, normalize=normalize)
    torch.cuda.synchronize()
    assert fastmnmf_rows.launches == before + 2
    for a, b, r in zip(got, again, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)  # bit-identical launches
        _close(a, r, RTOL[dt])
    if not normalize:
        assert got[1] is g and got[2] is W
        if guard == "one_norm":  # the planted bins keep their rows, bit for bit
            assert torch.equal(got[0][ZERO_U], Q[ZERO_U]) and torch.equal(got[0][ZERO_Q], Q[ZERO_Q])
        else:
            assert torch.isnan(got[0][ZERO_U]).any() and torch.isnan(got[0][ZERO_Q]).any()


@pytest.mark.parametrize("C", [2, 3, 4])
def test_a_bin_whose_qvq_reaches_the_eps_floor(cuda, C):
    """qVq about 1e-30, below eps^2: each of the bin's rows is q^H / eps,
    a thousandth of the row without the floor; every other bin is as
    without it, bit for bit."""
    U, Q, g, W = _operands(C, torch.complex128, cuda, seed=20 + C)
    floored = fastmnmf_rows(U, Q, g, W, EPS, THRESHOLD, guard="none", normalize=False)[0]
    free = fastmnmf_rows(U, Q, g, W, 1e-300, THRESHOLD, guard="none", normalize=False)[0]
    _close(floored, fastmnmf_rows_plain(U, Q, g, W, EPS, THRESHOLD, guard="none", normalize=False)[0], 1e-12)
    others = [f for f in range(F) if f not in (ZERO_U, ZERO_Q, HUGE_U)]
    assert torch.equal(floored[others], free[others])
    assert torch.isfinite(floored[HUGE_U]).all() and (floored[HUGE_U].abs() < 1e-2 * free[HUGE_U].abs()).all()


def _strided(t):
    """``t`` with its first and last axes' strides swapped: its values, not
    contiguous."""
    return t.transpose(0, -1).contiguous().transpose(0, -1)


BAD = {
    "a transposed diagonaliser": lambda U, Q, g, W: (U, Q.transpose(1, 2), g, W),
    "strided planes": lambda U, Q, g, W: (_strided(U), Q, g, W),
    "strided gains": lambda U, Q, g, W: (U, Q, _strided(g), W),
    "strided basis": lambda U, Q, g, W: (U, Q, g, _strided(W)),
    "a basis at float64": lambda U, Q, g, W: (U, Q, g, W.double()),
    "a complex128 diagonaliser": lambda U, Q, g, W: (U, Q.to(torch.complex128), g, W),
    "planes on the host": lambda U, Q, g, W: (U.cpu(), Q, g, W),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_k4_raises_on_what_it_does_not_take(cuda, case):
    args = BAD[case](*_operands(2, torch.complex64, cuda))
    assert not all(t.is_contiguous() and t.is_cuda and t.dtype in (torch.float32, torch.complex64) for t in args)
    before = fastmnmf_rows.launches
    with pytest.raises(ValueError):
        fastmnmf_rows(*args, EPS, THRESHOLD)
    assert fastmnmf_rows.launches == before


def _mixture(C, seed=0, F_=1025, T_=235):
    rng = np.random.RandomState(seed)
    X = (rng.randn(C, F_, T_) + 1j * rng.randn(C, F_, T_)) * (np.abs(rng.randn(C, 1, T_)) + 0.1)
    return torch.as_tensor(X.astype(np.complex64), device="cuda")


@pytest.mark.parametrize("C, kwargs", [(2, {}), (3, {}), (4, {}), (2, {"guard": "none"}), (2, {"normalize": False})],
                         ids=["c2", "c3", "c4", "none-c2", "unnormalised-c2"])
def test_captured_fastmnmf_equals_eager_with_k4_in_both(cuda, C, kwargs):
    """FastMNMF(10) captured against its eager loop from the same draws,
    bit for bit, with one K4 launch an iteration on each (the capture's own
    taken back, each replay counted), and the cached graph's."""
    X = _mixture(C)
    iteration = 10
    results = []
    for eager in (True, False):
        solver = FastMultichannelISNMF(n_basis=10, device="cuda", **kwargs)
        before = fastmnmf_rows.launches
        np.random.seed(111)
        Y = solver._eager_call(X, iteration=iteration) if eager else solver(X, iteration=iteration)
        torch.cuda.synchronize()
        assert fastmnmf_rows.launches - before == iteration
        results.append((Y, list(solver.loss), solver))
    (Y0, L0, _), (Y1, L1, graph) = results
    assert L0 == L1 and torch.equal(Y0, Y1)
    before = fastmnmf_rows.launches
    np.random.seed(111)
    graph(X, iteration=3)
    assert fastmnmf_rows.launches - before == 3 and sum(len(entry.steps) for entry in graph._graph_cache.values()) == 1

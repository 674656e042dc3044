"""Kernel K4's CPU side (``ops/mnmf_rows.py``): FastMNMF's row sweep and
per-bin power normalisation.

Its plain version gives the bits of the component sweep and the
normalisation as ``models/mnmf.py`` wrote them before K4 (restated below,
frozen), at complex64 and complex128, C = 2, 3, 4; a whole FastMNMF step
gives the bits of that step; FastMNMF calls K4's wrapper once an iteration
where the component route runs (C <= 4, guard ``one_norm`` or ``none``), and
the wrapper runs the plain version on the CPU; the wrapper's argument
checks raise before anything is built; ``k4_cost`` and its charge; and the
``k4_launches`` counter across a captured loop (emulated).  The card's
tests are ``tests/test_torch_cuda_mnmf_rows.py``.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.models import mnmf as port_mnmf
from audio_source_separation_tpu_torch.ops import _build, mnmf_rows
from audio_source_separation_tpu_torch.ops.fast_linalg import _sum
from audio_source_separation_tpu_torch.ops.ip_components import (
    _covariance_planes,
    assemble_components,
    det_components,
    pair_products_planes,
    solve_column_components,
)
from audio_source_separation_tpu_torch.ops.mnmf_rows import fastmnmf_rows, fastmnmf_rows_plain, k4_cost
from audio_source_separation_tpu_torch.runtime import profiling
from audio_source_separation_tpu_torch.runtime.cost_model import CostCounter
from audio_source_separation_tpu_torch.utils.flooring import EPS, THRESHOLD, floor_below

from conftest import make_mixture

F, T, S, K = 13, 24, 2, 3
DTYPES = {"c64": torch.complex64, "c128": torch.complex128}
# bins planted for the guard: a zero covariance (QV singular, a NaN
# condition number) and a zero diagonaliser
ZERO_U, ZERO_Q = 3, 7


def _frozen_sweep(U_planes, Q, eps, threshold, guard):
    """``FastMultichannelISNMF._update_diagonalizer``'s component branch as
    it stood before K4, after K1's call."""
    C = Q.shape[-1]
    U_all = assemble_components(U_planes)
    Q_rows = [[Q[:, i, c] for c in range(C)] for i in range(C)]
    for m in range(C):
        U = U_all[m]
        QV = [[_sum(Q_rows[i][c] * U[c][j] for c in range(C)) for j in range(C)] for i in range(C)]
        det = det_components(QV, C)
        q_m = solve_column_components(QV, C, m, det=det)
        ok = None
        if guard == "one_norm":
            inv_cols = [solve_column_components(QV, C, j, det=det) for j in range(C)]
            norm = torch.stack([_sum(torch.abs(QV[i][j]) for i in range(C)) for j in range(C)]).amax(dim=0)
            inv_norm = torch.stack(
                [_sum(torch.abs(inv_cols[j][i]) for i in range(C)) for j in range(C)]
            ).amax(dim=0)
            ok = norm * inv_norm < threshold
        Uq = [_sum(U[c][d] * q_m[d] for d in range(C)) for c in range(C)]
        qVq = _sum((q_m[c].conj() * Uq[c]).real for c in range(C))
        denominator = floor_below(torch.sqrt(qVq), eps)
        for c in range(C):
            new_c = q_m[c].conj() / denominator
            Q_rows[m][c] = new_c if ok is None else torch.where(ok, new_c, Q_rows[m][c])
    return torch.stack([torch.stack(row, dim=-1) for row in Q_rows], dim=1)


def _frozen_normalize(Q, g, W, H, eps, bins_sum=lambda x: x):
    """``FastMultichannelISNMF._normalize_state`` as it stood before K4."""
    QQsum = floor_below((Q * Q.conj()).real.sum(dim=2).mean(dim=1), eps)  # (F,)
    Q = Q / torch.sqrt(QQsum)[:, None, None].to(Q.dtype)
    g = g / QQsum[None, :, None]

    g_sum = floor_below(g.sum(dim=2), eps)
    g = g / g_sum[:, :, None]
    W = W * g_sum[:, :, None]

    Wsum = floor_below(bins_sum(W.sum(dim=1)), eps)
    W = W / Wsum[:, None]
    H = H * Wsum[:, :, None]
    return Q, g, W, H


def _same(a, b):
    """The same bits, NaN where NaN (a guard of ``none`` takes the planted
    bins' NaN rows)."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    return True


def _operands(C, dtype, seed=0, plant=True):
    """K1-shaped planes of a PSD covariance per row, a diagonaliser near
    the identity, gains and a basis; with ``plant`` the guard's bins."""
    gen = torch.Generator().manual_seed(seed)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    X = torch.complex(torch.randn(C, F, T, generator=gen), torch.randn(C, F, T, generator=gen)).to(dtype)
    weights = (10 ** (3 * torch.rand(C, F, T, generator=gen) - 1.5)).to(real)
    U = _covariance_planes(pair_products_planes(X), weights)
    noise = torch.complex(torch.randn(F, C, C, generator=gen), torch.randn(F, C, C, generator=gen))
    Q = (torch.eye(C) + 0.3 * noise).to(dtype).contiguous()
    if plant:
        U[:, ZERO_U] = 0
        Q[ZERO_Q] = 0
    g = torch.rand(S, F, C, generator=gen).to(real)
    W = torch.rand(S, F, K, generator=gen).to(real)
    return U, Q, g, W


@pytest.mark.parametrize("normalize", [True, False], ids=["power", "plain"])
@pytest.mark.parametrize("guard", ["one_norm", "none"])
@pytest.mark.parametrize("C", [2, 3, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_gives_the_bits_of_the_component_sweep_and_normalisation(dtype, C, guard, normalize):
    U, Q, g, W = _operands(C, DTYPES[dtype], seed=C)
    H = torch.rand(S, K, T, generator=torch.Generator().manual_seed(C)).to(g.dtype)
    want_Q = _frozen_sweep(U, Q, EPS, THRESHOLD, guard)
    want = _frozen_normalize(want_Q, g, W, H, EPS)
    for route in (fastmnmf_rows_plain, fastmnmf_rows):
        got_Q, got_g, got_W = route(U, Q, g, W, EPS, THRESHOLD, guard=guard, normalize=normalize)
        if not normalize:
            assert _same(got_Q, want_Q) and got_g is g and got_W is W
            continue
        assert _same(got_Q, want[0]) and _same(got_g, want[1])
        # the sum over bins stays the caller's: from K4's W it gives the chain's
        Wsum = floor_below(got_W.sum(dim=1), EPS)
        assert _same(got_W / Wsum[:, None], want[2]) and _same(H * Wsum[:, :, None], want[3])


@pytest.mark.parametrize("C", [2, 3, 4])
def test_the_guard_keeps_the_rows_of_the_planted_bins(C):
    """A bin whose covariance is zero, or whose diagonaliser is, has a NaN
    condition number: under ``one_norm`` it keeps every row, under
    ``none`` it takes the NaN rows."""
    U, Q, g, W = _operands(C, torch.complex128, seed=10 + C)
    kept, _, _ = fastmnmf_rows(U, Q, g, W, EPS, THRESHOLD, guard="one_norm", normalize=False)
    taken, _, _ = fastmnmf_rows(U, Q, g, W, EPS, THRESHOLD, guard="none", normalize=False)
    for f in (ZERO_U, ZERO_Q):
        assert torch.equal(kept[f], Q[f])
        assert torch.isnan(taken[f]).any()
    others = [f for f in range(F) if f not in (ZERO_U, ZERO_Q)]
    assert torch.isfinite(kept[others]).all() and not torch.equal(kept[others], Q[others])


@pytest.mark.parametrize("C", [2, 3, 4])
def test_a_bin_whose_qvq_reaches_the_eps_floor(C):
    """A covariance 1e30 times the rest gives qVq about 1e-30, below
    eps^2: each of the bin's rows is q^H / eps, a thousandth of the row
    without the floor, on both routes; every other bin is as without it."""
    U, Q, g, W = _operands(C, torch.complex128, seed=20 + C, plant=False)
    U[:, 4] *= 1e30
    floored = fastmnmf_rows(U, Q, g, W, EPS, THRESHOLD, guard="none", normalize=False)[0]
    free = fastmnmf_rows(U, Q, g, W, 1e-300, THRESHOLD, guard="none", normalize=False)[0]
    assert _same(floored, _frozen_sweep(U, Q, EPS, THRESHOLD, "none"))
    others = [f for f in range(F) if f != 4]
    assert torch.equal(floored[others], free[others])
    assert torch.isfinite(floored[4]).all() and (floored[4].abs() < 1e-2 * free[4].abs()).all()


def _step_operands(C, dtype, seed):
    X = torch.as_tensor(make_mixture(np.random.RandomState(seed), n_channels=C, n_bins=F, n_frames=T)).to(dtype)
    np.random.seed(111)
    solver = port.FastMultichannelISNMF(n_basis=K, device="cpu")
    state = solver.init_state(X, **solver.prepare_state_kwargs(X, {}))
    return solver, solver.update_state(state)  # one step from the identity, so Q is a general matrix


@pytest.mark.parametrize("C", [2, 3, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_fastmnmf_step_gives_the_bits_of_the_step_before_k4(dtype, C):
    solver, state = _step_operands(C, DTYPES[dtype], seed=C)
    after = solver.update_state(state)
    eps = solver.eps
    ref = solver._update_scm(solver._update_nmf(state))
    R = floor_below(solver._model_power(ref), eps)
    U = port_mnmf.weighted_covariance_planes(ref["input"], 1.0 / R)
    Q = _frozen_sweep(U, ref["diagonalizer"], eps, solver.threshold, solver.guard)
    Q, g, W, H = _frozen_normalize(Q, ref["spatial_covariance"], ref["basis"], ref["activation"], eps)
    for key, want in [("diagonalizer", Q), ("spatial_covariance", g), ("basis", W), ("activation", H)]:
        assert torch.equal(after[key], want), key


@pytest.mark.parametrize(
    "kwargs, C, calls",
    [({}, 2, 3), ({"guard": "none"}, 3, 3), ({}, 4, 3), ({"normalize": False}, 2, 3), ({"guard": "svd"}, 2, 0),
     ({}, 5, 0)],
    ids=["one_norm-C2", "none-C3", "one_norm-C4", "unnormalised", "svd", "C5"],
)
def test_fastmnmf_calls_k4_once_an_iteration_on_the_component_route(monkeypatch, kwargs, C, calls):
    """K4's wrapper once an iteration at C <= 4 under ``one_norm`` or
    ``none``, with ``normalize`` as the solver's; never under ``svd`` or
    past C = 4.  On the CPU the wrapper runs the plain version and builds
    nothing."""
    seen, plain = [], []
    wrapper, plain_fn = port_mnmf.fastmnmf_rows, mnmf_rows.fastmnmf_rows_plain

    def counted(*args, **kw):
        seen.append(kw["normalize"])
        return wrapper(*args, **kw)

    def counted_plain(*args, **kw):
        plain.append(1)
        return plain_fn(*args, **kw)

    def no_build(*args, **kw):
        raise AssertionError("K4 built on the CPU")

    monkeypatch.setattr(port_mnmf, "fastmnmf_rows", counted)
    monkeypatch.setattr(mnmf_rows, "fastmnmf_rows_plain", counted_plain)
    monkeypatch.setattr(mnmf_rows, "_entry", no_build)
    X = make_mixture(np.random.RandomState(111), n_channels=C, n_bins=9, n_frames=16)
    np.random.seed(111)
    port.FastMultichannelISNMF(n_basis=2, device="cpu", **kwargs)(X, iteration=calls or 3)
    assert seen == [kwargs.get("normalize", "power") == "power"] * calls
    assert len(plain) == calls


def _bad_calls():
    U, Q, g, W = _operands(2, torch.complex64, plant=False)
    meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    U5, _, g5, _ = _operands(4, torch.complex64, plant=False)
    return {
        "guard svd": ((U, Q, g, W), {"guard": "svd"}),
        "real diagonaliser": ((U, Q.real.contiguous(), g, W), {}),
        "C = 5": ((torch.zeros(25, F, 5), torch.zeros(F, 5, 5, dtype=torch.complex64), torch.zeros(S, F, 5), W), {}),
        "planes at float64": ((U.double(), Q, g, W), {}),
        "gains at float64": ((U, Q, g.double(), W), {}),
        "planes of another C": ((U5, Q, g, W), {}),
        "gains of another F": ((U, Q, g[:, :-1], W), {}),
        "basis of another S": ((U, Q, g, W[:1]), {}),
        "gains of another C": ((U, Q, g5, W), {}),
        "non-square diagonaliser": ((U, Q[:, :1], g, W), {}),
        "operands on two devices": ((meta(U), Q, g, W), {}),
        "a device without a route": ((meta(U), meta(Q), meta(g), meta(W)), {}),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_the_wrappers_checks_raise_before_any_build(monkeypatch, case):
    def no_build(*args, **kw):
        raise AssertionError("K4 built before its checks")

    monkeypatch.setattr(_build, "load", no_build)
    args, kwargs = _bad_calls()[case]
    with pytest.raises(ValueError):
        fastmnmf_rows(*args, EPS, THRESHOLD, **kwargs)


@pytest.mark.parametrize("normalize", [True, False], ids=["power", "plain"])
def test_k4_cost_counts_the_bytes_of_a_hand_counted_shape(normalize):
    """The cell's shape, C = 2, S = 2, K = 10, 2049 bins, complex64: the
    planes 4 x 2049 x 2 floats, Q 2049 x 4 complex read and written, with
    ``normalize`` g 2 x 2049 x 2 and W 2 x 2049 x 10 floats read and
    written."""
    planes, diagonaliser = 4 * 2049 * 2 * 4, 2 * 2049 * 4 * 8
    gains_basis = 2 * (2 * 2049 * 2 + 2 * 2049 * 10) * 4 if normalize else 0
    n_bytes, flops = k4_cost(2, 2, 10, 2049, normalize, 8)
    assert n_bytes == planes + diagonaliser + gains_basis == (590_112 if normalize else 196_704)
    assert flops == 2049 * 2 * (16 * 8 + 8 * 4 + 4 * 2) + (2049 * (6 * 4 + 3 * 2 * 2 + 2 * 10) if normalize else 0)
    assert k4_cost(2, 2, 10, 2049, normalize, 16)[0] == 2 * n_bytes


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_k4_call_charges_k4_cost_only(dtype):
    U, Q, g, W = _operands(3, DTYPES[dtype])
    counter = CostCounter()
    with counter:
        fastmnmf_rows(U, Q, g, W, EPS, THRESHOLD)
    assert counter.charges == {"K4": 1} and list(counter.by_op) == ["kernel:K4"]
    assert (counter.bytes, counter.flops) == k4_cost(3, S, K, F, True, Q.element_size())


def test_k4_launches_count_one_an_iteration_across_the_captured_loop(monkeypatch):
    """With each call standing for a launch, the emulated captured loop
    counts one for the eager step and one for each replay, as the card's
    does, and the solver call's span carries them as ``k4_launches``."""
    route = mnmf_rows._fastmnmf_rows

    def launched(*args):
        mnmf_rows.fastmnmf_rows.launches += 1
        return route(*args)

    monkeypatch.setattr(mnmf_rows, "_fastmnmf_rows", launched)
    X = torch.as_tensor(make_mixture(np.random.RandomState(4), n_channels=2, n_bins=9, n_frames=16))
    iteration = 6
    solver = port.FastMultichannelISNMF(n_basis=2, device="cpu")
    solver._emulate_graph = True
    for call in range(2):  # the capture, then the cached graph
        before = mnmf_rows.fastmnmf_rows.launches
        np.random.seed(111)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            solver(X, iteration=iteration)
        assert mnmf_rows.fastmnmf_rows.launches - before == iteration
        solve = [s for s in profiling.spans() if s.name == "solve"][-1]
        assert solve.attrs["k4_launches"] == iteration
        assert solve.attrs["graph_replays"] == iteration - 1 and solve.attrs["graph_captures"] == 1 - call

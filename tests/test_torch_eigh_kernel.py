"""K3, the batched Hermitian eigensolver (``ops/eigh_kernel.py``,
``csrc/batched_eigh.cu``): its launch plan, cost and plain version on the
CPU, and the kernel against its plain version on the card.

This file imports neither JAX nor ``conftest``; the card's tests run with

    python -m pytest tests/test_torch_eigh_kernel.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

from audio_source_separation_tpu_torch.ops import eigh_kernel
from audio_source_separation_tpu_torch.ops.eigh_kernel import (
    MAX_N,
    SHARED_N,
    batched_eigh,
    batched_eigh_plain,
    eigh_cost,
    group_words,
    k3_launch_plan,
)
from audio_source_separation_tpu_torch.runtime.cost_model import CostCounter
from audio_source_separation_tpu_torch.runtime.graph import StepGraph, new_stream, on_stream

COMPLEX = {torch.float32: False, torch.float64: False, torch.complex64: True, torch.complex128: True}


def hermitian(rng, batch, n, dtype, kind="indefinite"):
    """Seeded Hermitian (or symmetric) ``(*batch, n, n)`` matrices: random
    indefinite, PSD of rank ``n // 2``, or with repeated eigenvalues."""
    shape = (*batch, n, n)
    A = rng.randn(*shape) + (1j * rng.randn(*shape) if COMPLEX[dtype] else 0)
    if kind == "indefinite":
        H = A + np.swapaxes(A, -1, -2).conj()
    elif kind == "rank":
        B = A[..., : max(1, n // 2)]
        H = B @ np.swapaxes(B, -1, -2).conj()
    else:  # repeated: Q diag(1, 1, 2, 2, ...) Q^H
        Q, _ = np.linalg.qr(A)
        d = np.repeat(np.arange(1, n // 2 + 2), 2)[:n].astype(float)
        H = (Q * d[..., None, :]) @ np.swapaxes(Q, -1, -2).conj()
    return torch.as_tensor(H).to(dtype)


# --------------------------------------------------------------------------- #
# the CPU: plan, cost, plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 2, 3, 4, 9, 16, 17, 64, SHARED_N, SHARED_N + 1, 128, MAX_N])
@pytest.mark.parametrize("complex_", [True, False])
def test_launch_plan(n, complex_):
    """A group covers a round's pairs in one pass up to a warp; one block a
    matrix past ``WARP_N``; a plan's slots fit a block's shared memory, or
    sit in a workspace of one slot a block, the blocks walking the batch."""
    plan = k3_launch_plan(n, 1000, complex_, True)
    m = n + n % 2
    if n <= eigh_kernel.WARP_N:
        assert plan.group <= 32 and plan.group & (plan.group - 1) == 0
        assert plan.group >= min(32, n * m // 2) and plan.threads == eigh_kernel.WARP_THREADS
    else:
        assert plan.group == plan.threads == eigh_kernel.BLOCK_THREADS and plan.per_block == 1
    assert plan.per_block * plan.group == plan.threads
    slot = group_words(n, complex_, True) * 8
    if plan.smem_bytes:
        assert plan.blocks == -(-1000 // plan.per_block) and plan.workspace_bytes == 0
        assert plan.smem_bytes == plan.per_block * slot <= eigh_kernel.SMEM_LIMIT
    else:
        assert plan.per_block == 1 and slot > eigh_kernel.SMEM_LIMIT
        assert 1 <= plan.blocks <= min(1000, eigh_kernel.WORKSPACE_BLOCKS)
        assert plan.workspace_bytes == plan.blocks * slot <= max(slot, eigh_kernel.WORKSPACE_LIMIT)
    assert group_words(n, complex_, True) % 2 == 0


def test_launch_plan_limits():
    """``SHARED_N`` is the largest order whose complex128 A and V fit a
    block's shared memory, and the next takes the workspace; a small batch
    takes no more blocks than matrices; past ``MAX_N``, and at n < 1, the
    plan raises."""
    assert 0 < k3_launch_plan(SHARED_N, 1).smem_bytes <= eigh_kernel.SMEM_LIMIT
    wide = k3_launch_plan(SHARED_N + 1, 1)
    assert wide.smem_bytes == 0 and wide.blocks == 1 and wide.workspace_bytes == group_words(SHARED_N + 1, True, True) * 8
    assert k3_launch_plan(MAX_N, 10**6).workspace_bytes <= eigh_kernel.WORKSPACE_LIMIT
    for n in (0, MAX_N + 1):
        with pytest.raises(ValueError):
            k3_launch_plan(n, 1)


def test_cost():
    """The matrices read once, eigenvalues and vectors written once;
    LAPACK's dense count, four times at a complex type."""
    assert eigh_cost(3, 10, True, True, 8) == (10 * (9 * 8 + 3 * 4 + 9 * 8), 10 * 9 * 27 * 4)
    assert eigh_cost(4, 2, False, False, 8) == (2 * (16 * 8 + 4 * 8), 2 * 4 / 3 * 64)


@pytest.mark.parametrize("dtype", list(COMPLEX))
@pytest.mark.parametrize("kind", ["indefinite", "rank", "repeated"])
def test_plain_version_is_eigh_at_double(dtype, kind):
    """The CPU route: ``torch.linalg.eigh`` at float64 or complex128, cast
    back; eigenvalues alone without vectors; bits as a direct call's at
    double precision."""
    rng = np.random.RandomState(3)
    H = hermitian(rng, (4, 3), 6, dtype, kind)
    w, V = batched_eigh(H)
    wide = torch.complex128 if H.is_complex() else torch.float64
    w_ref, V_ref = torch.linalg.eigh(H.to(wide))
    assert w.dtype == H.real.dtype and V.dtype == H.dtype and w.shape == (4, 3, 6) and V.shape == H.shape
    assert torch.equal(w, w_ref.to(w.dtype)) and torch.equal(V, V_ref.to(V.dtype))
    assert torch.equal(batched_eigh(H, vectors=False), torch.linalg.eigvalsh(H.to(wide)).to(w.dtype))


def test_plain_version_gives_nan_for_non_finite_matrices():
    rng = np.random.RandomState(4)
    H = hermitian(rng, (5,), 4, torch.float64)
    H[2, 0, 3] = float("inf")
    w, V = batched_eigh(H)
    assert torch.isnan(w[2]).all() and torch.isnan(V[2]).all()
    keep = torch.tensor([0, 1, 3, 4])
    assert torch.isfinite(w[keep]).all() and torch.isfinite(V[keep]).all()


def test_charged_as_one_call_on_the_cpu():
    """Inside a cost count a call charges ``eigh_cost`` once and none of
    the plain version's ops."""
    H = hermitian(np.random.RandomState(5), (7,), 5, torch.complex128)
    with CostCounter() as counter:
        batched_eigh(H)
    assert counter.charges == {"K3": 1}
    assert (counter.bytes, counter.flops) == eigh_cost(5, 7, True, True, 16)


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# tolerances of K3 against the plain version, relative to the largest
# eigenvalue's modulus: float64 arithmetic in both, rounded to the type
RTOL = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-10, torch.complex128: 1e-10}


def _check(H, w, V, rtol):
    """K3's result against the plain version: eigenvalues, ``|HV - VL| /
    |H|``, ``|V^H V - I|``, and the phase convention."""
    wide = torch.complex128 if H.is_complex() else torch.float64
    Hd, Vd, wd = H.to(wide), V.to(wide), w.to(torch.float64)
    w_ref = batched_eigh_plain(H.to(wide), vectors=False)
    scale = w_ref.abs().amax(dim=-1, keepdim=True).clamp(min=1e-300)
    assert ((wd - w_ref).abs() / scale).max() <= rtol
    assert (wd[..., 1:] >= wd[..., :-1]).all()
    norm = torch.linalg.matrix_norm(Hd)[..., None, None]
    assert ((Hd @ Vd - Vd * wd[..., None, :].to(wide)).abs() / norm).max() <= 10 * rtol
    eye = torch.eye(H.shape[-1], dtype=wide, device=H.device)
    assert (Vd.mH @ Vd - eye).abs().max() <= 10 * rtol
    # each vector has an entry of largest modulus (to rounding: near-ties
    # order either way) that is real and positive
    top = Vd.abs() >= Vd.abs().amax(dim=-2, keepdim=True) - 10 * rtol
    lead = (Vd.real > 0) & (Vd.imag.abs() <= 10 * rtol if H.is_complex() else True)
    assert (top & lead).any(dim=-2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(COMPLEX))
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9, 16, 17, 33, 64, SHARED_N, SHARED_N + 1, 128])
def test_kernel_matches_plain(cuda, dtype, n):
    rng = np.random.RandomState(n)
    for kind in ("indefinite", "rank", "repeated"):
        H = hermitian(rng, (37,), n, dtype, kind).to(cuda)
        before = batched_eigh.launches
        w, V = batched_eigh(H)
        w_only = batched_eigh(H, vectors=False)
        torch.cuda.synchronize()
        assert batched_eigh.launches == before + 2
        _check(H, w, V, RTOL[dtype])
        assert torch.equal(w_only, w)


@pytest.mark.cuda
def test_kernel_reads_the_lower_triangle_and_gives_nan(cuda):
    """The upper triangle is not read (LAPACK's UPLO = 'L'); a matrix with
    a non-finite entry, in either triangle, gives NaN alone."""
    rng = np.random.RandomState(8)
    H = hermitian(rng, (6,), 9, torch.complex64).to(cuda)
    L = torch.tril(H) + torch.triu(torch.full_like(H, 7.0 + 3.0j), diagonal=1)
    assert torch.equal(batched_eigh(L)[0], batched_eigh(H)[0])
    H[1, 0, 4] = float("nan")
    H[3, 5, 2] = float("inf")
    w, V = batched_eigh(H)
    bad = torch.tensor([False, True, False, True, False, False], device=cuda)
    assert torch.isnan(w[bad]).all() and torch.isnan(V[bad]).all()
    assert torch.isfinite(w[~bad]).all() and torch.isfinite(V[~bad]).all()


@pytest.mark.cuda
def test_kernel_is_deterministic_and_takes_any_batch(cuda):
    rng = np.random.RandomState(9)
    H = hermitian(rng, (2, 50_000), 3, torch.complex64).to(cuda)
    w1, V1 = batched_eigh(H)
    w2, V2 = batched_eigh(H)
    assert torch.equal(w1, w2) and torch.equal(V1, V2)
    _check(H[:, :500], w1[:, :500], V1[:, :500], RTOL[torch.complex64])
    sweeps = torch.zeros(H.shape[:-2], dtype=torch.int32, device=cuda).reshape(-1)
    batched_eigh(H, sweeps=sweeps)
    assert 1 <= int(sweeps.min()) and int(sweeps.max()) <= eigh_kernel.MAX_SWEEPS


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 2])
def test_kernel_converges_on_rank_deficient_matrices(cuda, rank):
    """PSD matrices of rank 1 or 2 (Sawada's covariances ``x x^H`` are of
    rank 1) converge in as few sweeps as full-rank ones do: round-off
    between their zero eigenvalues is not chased to the cap."""
    rng = np.random.RandomState(11 + rank)
    for n in (3, 9, 64):
        A = rng.randn(200, n, rank) + 1j * rng.randn(200, n, rank)
        H = torch.as_tensor(A @ np.swapaxes(A, -1, -2).conj()).to(torch.complex64).to(cuda)
        sweeps = torch.zeros(200, dtype=torch.int32, device=cuda)
        w, V = batched_eigh(H, sweeps=sweeps)
        _check(H, w, V, RTOL[torch.complex64])
        assert int(sweeps.max()) <= 12


@pytest.mark.cuda
def test_kernel_gives_nan_past_the_sweep_cap(cuda, monkeypatch):
    """A matrix that still rotates in its last allowed sweep gives NaN
    eigenvalues and vectors; one already diagonal converges in one."""
    rng = np.random.RandomState(12)
    H = hermitian(rng, (4,), 9, torch.float64).to(cuda)
    H[2] = torch.diag(torch.arange(9.0, dtype=torch.float64, device=cuda))
    monkeypatch.setattr(eigh_kernel, "MAX_SWEEPS", 1)
    sweeps = torch.zeros(4, dtype=torch.int32, device=cuda)
    w, V = batched_eigh(H, sweeps=sweeps)
    diagonal = torch.tensor([False, False, True, False], device=cuda)
    assert torch.isnan(w[~diagonal]).all() and torch.isnan(V[~diagonal]).all()
    assert torch.equal(w[2], torch.arange(9.0, dtype=torch.float64, device=cuda))
    assert torch.equal(V[2], torch.eye(9, dtype=torch.float64, device=cuda))
    assert sweeps.tolist() == [1, 1, 1, 1]


@pytest.mark.cuda
def test_kernel_replays_in_a_graph(cuda):
    """Captured and replayed, K3 equals its eager launch bit for bit and is
    counted once a replay."""
    H = hermitian(np.random.RandomState(10), (469,), 64, torch.float32).to(cuda)

    def step(state):
        w, V = batched_eigh(state["H"])
        return {"H": state["H"] * 1.0, "w": w, "V": V}

    first = step({"H": H})
    stream = new_stream(cuda)
    with on_stream(stream):
        graph = StepGraph("k3", step(first), step, stream=stream)
    before = batched_eigh.launches
    graph.replay(2)
    torch.cuda.synchronize()
    assert batched_eigh.launches == before + 2
    assert torch.equal(graph.static["w"], first["w"]) and torch.equal(graph.static["V"], first["V"])

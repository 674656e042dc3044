"""Kernel K5 (``csrc/fastmnmf_mu.cu``, ``ops/mnmf_mu.py``) on the card.

Each of K5's five entries against its plain version at the FastMNMF cell's
2 x 2049 x 470 with K = 10, at float32 and float64 (the real types of
complex64 and complex128), fused and with the statistics written for a
mesh's all-reduce; at C = 3 (K = 8), at T = 33 and T = 4688, at K = 1
and at the largest S K the kernel takes; bit-identical launches, one
counted a call;
the raises on what the kernel does not take; FastMNMF's 50-iteration call
captured against its eager loop and against itself bit for bit, with K5's
launches as counted; the launches during a cost count equal to its K5
charges; and a shape past the kernel's limits on the plain route.

Needs an NVIDIA GPU with ``nvcc``; each test skips without one.  This file
imports neither JAX nor ``conftest``:

    python -m pytest tests/test_torch_cuda_mnmf_mu.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

from audio_source_separation_tpu_torch import FastMultichannelISNMF
from audio_source_separation_tpu_torch.ops import mnmf_mu
from audio_source_separation_tpu_torch.ops.mnmf_mu import ENTRIES, MAX_J, fastmnmf_mu, fastmnmf_mu_plain
from audio_source_separation_tpu_torch.runtime.profiling import iteration_cost
from audio_source_separation_tpu_torch.utils.flooring import EPS

pytestmark = pytest.mark.cuda

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# K5 against the plain version, relative to the result's largest entry
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(M, S, K, F, T, dtype, device, seed=0):
    """Powers over five decades, as ``|Q x|^2`` of a song spreads, and
    factors uniform in (0.05, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device, dtype=torch.float64)  # noqa: E731
    x = 10 ** (5 * rand(M, F, T) - 3)
    W, g, H = (0.05 + 0.95 * rand(*shape) for shape in ((S, F, K), (S, F, M), (S, K, T)))
    return [t.to(dtype) for t in (x, W, g, H)]


def _close(a, b, rtol):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    err = float((a - b).abs().max() / b.abs().max())
    assert err <= rtol, err


def _identity(sums):
    return list(sums)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k5_matches_its_plain_version_at_the_cells_shape(cuda, dtype, entry):
    dt = DTYPES[dtype]
    ops = _operands(2, 2, 10, 2049, 470, dt, cuda)
    before = fastmnmf_mu.launches
    got = fastmnmf_mu(entry, *ops, EPS)
    again = fastmnmf_mu(entry, *ops, EPS)
    ref = fastmnmf_mu_plain(entry, *ops, EPS)
    torch.cuda.synchronize()
    assert fastmnmf_mu.launches == before + 2
    assert torch.equal(got, again)  # bit-identical launches
    _close(got, ref, RTOL[dt])


@pytest.mark.parametrize("entry", ["basis", "gains", "activation"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k5_writes_the_statistics_for_a_mesh(cuda, dtype, entry):
    """With ``whole`` the kernel writes the partial sums, ``whole`` makes
    them whole and the update follows in PyTorch in the kernel's order: one
    launch, the fused launch's bits, as close to the plain version."""
    dt = DTYPES[dtype]
    ops = _operands(2, 2, 10, 2049, 470, dt, cuda, seed=1)
    seen = []

    def whole(sums):
        seen.append([tuple(s.shape) for s in sums])
        return list(sums)

    before = fastmnmf_mu.launches
    got = fastmnmf_mu(entry, *ops, EPS, whole=whole)
    assert fastmnmf_mu.launches == before + 1
    stats = (2, 2049, 2, 10) if entry != "activation" else (2, 10, 470)
    assert seen == [[stats, stats]]
    _close(got, fastmnmf_mu_plain(entry, *ops, EPS), RTOL[dt])
    assert torch.equal(got, fastmnmf_mu(entry, *ops, EPS))


@pytest.mark.parametrize(
    "M, S, K, T",
    [(3, 3, 8, 470), (2, 2, 10, 33), (2, 2, 10, 4688), (2, 2, 1, 470), (4, 4, MAX_J // 4, 470), (1, 1, MAX_J, 97)],
    ids=["C3", "T33", "T4688", "K1", "C4-largest-SK", "S1-largest-K"],
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k5_matches_its_plain_version_at_other_shapes(cuda, dtype, M, S, K, T):
    dt = DTYPES[dtype]
    ops = _operands(M, S, K, 2049, T, dt, cuda, seed=M + K + T)
    for entry in ENTRIES:
        _close(fastmnmf_mu(entry, *ops, EPS), fastmnmf_mu_plain(entry, *ops, EPS), RTOL[dt])
        if entry in ("basis", "gains", "activation"):
            _close(fastmnmf_mu(entry, *ops, EPS, whole=_identity), fastmnmf_mu_plain(entry, *ops, EPS), RTOL[dt])


def test_the_model_floor(cuda):
    """Bins whose model is below ``eps`` read the floor: the weights are
    ``1 / eps`` there, and every result stays as the plain version's."""
    x, W, g, H = _operands(2, 2, 10, 513, 64, torch.float64, cuda, seed=3)
    W[:, :7] = 0
    for entry in ENTRIES:
        _close(fastmnmf_mu(entry, x, W, g, H, EPS), fastmnmf_mu_plain(entry, x, W, g, H, EPS), 1e-12)
    assert torch.equal(fastmnmf_mu("weights", x, W, g, H, EPS)[:, :7], torch.full((2, 7, 64), 1 / EPS, device=cuda,
                                                                                    dtype=torch.float64))


def _strided(t):
    return t.transpose(0, -1).contiguous().transpose(0, -1)


BAD = {
    "strided powers": lambda x, W, g, H: (_strided(x), W, g, H),
    "strided activations": lambda x, W, g, H: (x, W, g, _strided(H)),
    "a basis at float64": lambda x, W, g, H: (x, W.double(), g, H),
    "gains on the host": lambda x, W, g, H: (x, W, g.cpu(), H),
    "five channels": lambda x, W, g, H: (torch.cat([x, x, x[:1]]), W, torch.cat([g, g, g[:, :, :1]], dim=2), H),
    "S K past the limit": lambda x, W, g, H: (x, W.repeat(1, 1, 3), g, H.repeat(1, 3, 1)),
    "a complex basis": lambda x, W, g, H: (x, W.to(torch.complex64), g, H),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_k5_raises_on_what_it_does_not_take(cuda, case):
    args = BAD[case](*_operands(2, 2, 10, 129, 40, torch.float32, cuda))
    before = fastmnmf_mu.launches
    with pytest.raises(ValueError):
        fastmnmf_mu("basis", *args, EPS)
    assert fastmnmf_mu.launches == before


def _mixture(C, seed=0, F_=2049, T_=470):
    rng = np.random.RandomState(seed)
    X = (rng.randn(C, F_, T_) + 1j * rng.randn(C, F_, T_)) * (np.abs(rng.randn(C, 1, T_)) + 0.1)
    return torch.as_tensor(X.astype(np.complex64), device="cuda")


@pytest.mark.parametrize(
    "C, n_basis, kwargs", [(2, 10, {}), (3, 8, {}), (2, 10, {"guard": "svd"})], ids=["c2", "c3", "svd-c2"]
)
def test_fastmnmf_50_iterations_captured_equals_eager_and_itself(cuda, C, n_basis, kwargs):
    """FastMNMF x 50 captured against its eager loop from the same
    draws, bit for bit, and a second captured call against the first; K5
    launched four times an iteration and once for each of the 51 losses on
    each (the svd guard runs eager on both: its step is not captured)."""
    X = _mixture(C)
    iteration = 50
    results = []
    for eager in (True, False, False):
        solver = FastMultichannelISNMF(n_basis=n_basis, device="cuda", **kwargs)
        before = fastmnmf_mu.launches
        np.random.seed(111)
        Y = solver._eager_call(X, iteration=iteration) if eager else solver(X, iteration=iteration)
        torch.cuda.synchronize()
        assert fastmnmf_mu.launches - before == 4 * iteration + iteration + 1
        results.append((Y, list(solver.loss)))
    (Y0, L0), (Y1, L1), (Y2, L2) = results
    assert np.isfinite(L0).all()
    assert L0 == L1 == L2 and torch.equal(Y0, Y1) and torch.equal(Y1, Y2)


def test_launches_during_a_cost_count_equal_its_charges(cuda):
    """One FastMNMF iteration under the cost model: four K5 charges (the
    basis, the activations, the gains, K1's weights) and as many
    launches."""
    X = _mixture(2, F_=513, T_=120)
    solver = FastMultichannelISNMF(n_basis=10, device="cuda")
    np.random.seed(111)
    before = fastmnmf_mu.launches
    counter = iteration_cost(solver, X)
    assert counter.charges["K5"] == 4
    assert fastmnmf_mu.launches - before == counter.charges["K5"]


def test_a_shape_past_the_limits_keeps_the_plain_route(cuda, monkeypatch):
    """At n_basis = 13 (S K = 26 > 24) FastMNMF never launches the kernel
    and takes the plain version (in its init's loss and its eager first
    step; the captured replays call no Python); the wrapper raises on the
    same operands."""
    X = _mixture(2, F_=257, T_=60)
    calls = []
    real = mnmf_mu.fastmnmf_mu_plain
    monkeypatch.setattr("audio_source_separation_tpu_torch.models.mnmf.fastmnmf_mu_plain",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    before = fastmnmf_mu.launches
    solver = FastMultichannelISNMF(n_basis=13, device="cuda")
    np.random.seed(111)
    solver(X, iteration=3)
    torch.cuda.synchronize()
    assert fastmnmf_mu.launches == before
    assert set(calls) == set(ENTRIES)
    assert np.isfinite(solver.loss).all()
    W = solver.basis.contiguous()
    x = torch.ones((2, 257, 60), device="cuda")
    with pytest.raises(ValueError):
        fastmnmf_mu("weights", x, W, solver.spatial_covariance.contiguous(), solver.activation.contiguous(), EPS)

"""The captured solver loop (``runtime/graph.py``) on the CPU at float64,
and on the card.

On the CPU nothing is captured: ``solver._emulate_graph = True`` runs the
runner's static-buffer path (the static state, the copy-back, the loss slot,
the cache, the launch bookkeeping), each replay an eager call of the step.
For every family and configuration of the slice it must equal the eager
loop bit for bit; the main path of each family is held to the JAX
package's loss trajectory at rtol 1e-9, as the eager port is.

The ``cuda`` tests need a card; this file imports JAX only inside the
fixtures of the JAX tests, so on a machine without JAX they run with

    python -m pytest tests/test_torch_graph_loop.py --noconftest -q -m cuda
"""

import warnings

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import models as port_models
from audio_source_separation_tpu_torch.ops.cov_kernel import weighted_covariance_planes
from audio_source_separation_tpu_torch.ops.fused_ip import fused_auxiva_ip_iter
from audio_source_separation_tpu_torch.parallel import batch_separate
from audio_source_separation_tpu_torch.runtime.graph import GraphCaptureError, StepGraph, new_stream, on_stream
from audio_source_separation_tpu_torch.runtime.profiling import benchmark_solver
from audio_source_separation_tpu_torch.runtime.solver import IterativeSolver

ITERATIONS = 6
SEED = 111


def _step_graphs(solver):
    """The step graphs of the solver's cache, over its call signatures."""
    return [g for entry in vars(solver).get("_graph_cache", {}).values() for g in entry.steps.values()]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _input(kind, seed=0, F=33, T=40):
    """A seeded input of each model's kind: a ``(C, F, T)`` mixture, a power
    or complex ``(F, T)`` target, a nonnegative ``(3, F, T)`` tensor."""
    rng = np.random.RandomState(seed)
    if kind.startswith("mix"):
        C = int(kind[3:])
        return rng.randn(C, F, T) + 1j * rng.randn(C, F, T)
    if kind == "power":
        return np.abs(rng.randn(F, 3)) @ np.abs(rng.randn(3, T)) + 0.01 * np.abs(rng.randn(F, T))
    if kind == "complex":
        return (rng.randn(F, T) + 1j * rng.randn(F, T)) * 0.5
    return np.abs(rng.randn(3, F, T)) ** 2


# (id, class, kwargs, input kind): every family and configuration of the slice
CASES = [
    ("iva-ip-c2", "AuxLaplaceIVA", {}, "mix2"),  # the main path: K2's plain version
    ("gauss-iva-ip-c2", "AuxGaussIVA", {}, "mix2"),
    ("iva-ip-c3", "AuxLaplaceIVA", {}, "mix3"),  # K1, (N, T) weights
    ("gauss-iva-ip-c3", "AuxGaussIVA", {}, "mix3"),
    ("iva-ip-c5", "AuxLaplaceIVA", {}, "mix5"),  # the matrix sweep
    ("iva-ip-none-c2", "AuxLaplaceIVA", {"guard": "none"}, "mix2"),
    ("iva-iss", "AuxLaplaceIVA", {"algorithm_spatial": "ISS"}, "mix2"),
    ("gauss-iva-iss-c3", "AuxGaussIVA", {"algorithm_spatial": "ISS"}, "mix3"),
    ("iva-ip2-c3", "AuxLaplaceIVA", {"algorithm_spatial": "IP2"}, "mix3"),
    ("ilrma-ip", "GaussILRMA", {"n_basis": 2}, "mix2"),  # K1, per-bin weights
    ("ilrma-iss", "GaussILRMA", {"n_basis": 2, "algorithm_spatial": "ISS"}, "mix2"),
    ("ilrma-ip2", "GaussILRMA", {"n_basis": 2, "algorithm_spatial": "IP2"}, "mix2"),
    ("ilrma-pb-c4", "GaussILRMA", {"n_basis": 2, "normalize": "projection-back"}, "mix4"),  # a per-bin solve
    ("tilrma", "TILRMA", {"n_basis": 2}, "mix2"),
    ("consistent-ilrma", "ConsistentGaussILRMA", {"n_basis": 2, "fft_size": 64}, "mix2"),
    ("fastmnmf", "FastMultichannelISNMF", {"n_basis": 2}, "mix2"),
    ("fastmnmf-c3", "FastMultichannelISNMF", {"n_basis": 2}, "mix3"),
    ("eucnmf", "EUCNMF", {"n_basis": 3}, "power"),
    ("klnmf", "KLNMF", {"n_basis": 3}, "power"),
    ("isnmf-mm", "ISNMF", {"n_basis": 3}, "power"),
    ("isnmf-me", "ISNMF", {"n_basis": 3, "algorithm": "me"}, "power"),
    ("tnmf", "TNMF", {"n_basis": 3}, "power"),
    ("cauchy-naive", "CauchyNMF", {"n_basis": 3}, "power"),
    ("cauchy-mm", "CauchyNMF", {"n_basis": 3, "algorithm": "mm"}, "power"),
    ("cauchy-me", "CauchyNMF", {"n_basis": 3, "algorithm": "me"}, "power"),
    ("cauchy-mm-fast", "CauchyNMF", {"n_basis": 3, "algorithm": "mm_fast"}, "power"),
    ("complex-eucnmf", "ComplexEUCNMF", {"n_basis": 3}, "complex"),
    ("eucntf", "EUCNTF", {"n_basis": 3}, "tensor"),
]
IDS = [c[0] for c in CASES]
BY_ID = {c[0]: c for c in CASES}
# the main path of each family, held to the JAX package's trajectory
JAX_CASES = [
    "iva-ip-c2", "gauss-iva-ip-c2", "iva-ip-c3", "iva-iss", "iva-ip2-c3", "ilrma-ip", "ilrma-ip2", "tilrma",
    "consistent-ilrma", "fastmnmf", "isnmf-mm", "complex-eucnmf", "eucntf",
]


def _solver(case, emulate=True, **extra):
    _, name, kwargs, _ = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # GaussILRMA ISS: "in progress"
        solver = getattr(port, name)(device="cpu", **kwargs, **extra)
    solver._emulate_graph = emulate
    return solver


def _call(solver, X, iteration=ITERATIONS, seed=SEED, **kwargs):
    np.random.seed(seed)  # the host draws of prepare_state_kwargs
    return solver(X, iteration=iteration, **kwargs)


def _parts(output):
    return output if isinstance(output, tuple) else (output,)


def _published(solver):
    """The published state fields, as tensors (``None`` where unset)."""
    return {k: getattr(solver, k, None) for k in solver.state_fields}


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graph_equals_eager_loop(case):
    """Losses, output and published state bit for bit the eager loop's, with
    one graph in the cache."""
    X = _input(case[3])
    eager, graph = _solver(case, emulate=False), _solver(case)
    Y0, Y1 = _call(eager, X), _call(graph, X)
    assert graph.capturable(X) and len(_step_graphs(graph)) == 1
    assert not vars(eager).get("_graph_cache")
    assert eager.loss == graph.loss and len(graph.loss) == ITERATIONS + graph.record_initial_loss
    _assert_same(_parts(Y0), _parts(Y1))
    _assert_same(list(_published(eager).values()), list(_published(graph).values()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_reuse_and_no_aliasing(case):
    """A second call of the same shape replays the cached graph and equals a
    fresh solver's call; call 1's output and published attributes are
    untouched by it; a new shape adds an entry."""
    kind = case[3]
    X1, X2 = _input(kind, seed=1), _input(kind, seed=2)
    solver = _solver(case)
    Y1 = _parts(_call(solver, X1))
    held = {k: v for k, v in _published(solver).items() if isinstance(v, torch.Tensor)}
    copies = [y.clone() for y in Y1], {k: v.clone() for k, v in held.items()}
    (graph,) = _step_graphs(solver)
    n_loss = len(solver.loss)

    Y2 = _parts(_call(solver, X2, seed=SEED + 1))
    assert _step_graphs(solver) == [graph]
    fresh = _solver(case)
    _assert_same(Y2, _parts(_call(fresh, X2, seed=SEED + 1)))
    assert solver.loss[n_loss:] == fresh.loss
    _assert_same(Y1, copies[0])
    _assert_same([held[k] for k in held], [copies[1][k] for k in held])
    for v in list(Y1) + list(Y2) + list(held.values()) + [t for t in _published(solver).values() if t is not None]:
        assert all(v.untyped_storage().data_ptr() != s.untyped_storage().data_ptr() for s in graph.static.values())

    F = 17
    X3 = _input(kind, seed=3, F=F)
    _call(solver, X3)
    assert len(_step_graphs(solver)) == 2


@pytest.fixture(scope="module")
def jax_models():
    import audio_source_separation_tpu.models as models

    return models


@pytest.mark.parametrize("case_id", JAX_CASES)
def test_graph_matches_jax_trajectory(jax_models, case_id):
    case = BY_ID[case_id]
    _, name, kwargs, kind = case
    X = _input(kind)
    np.random.seed(SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = getattr(jax_models, name)(**kwargs)
        ref_out = ref(X, iteration=ITERATIONS)
    ours = _solver(case)
    out = _call(ours, X)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    for a, b in zip(_parts(out), ref_out if isinstance(ref_out, tuple) else (ref_out,)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-8)


def test_ip2_resumes_jax_checkpoint_through_graph(jax_models, tmp_path):
    """A JAX IP2 checkpoint (its ``step_count`` a device tensor in the
    port's state) resumes through the graph onto JAX's uninterrupted run."""
    from audio_source_separation_tpu_torch import state_from_jax

    X = _input("mix3", seed=4)
    first = jax_models.AuxLaplaceIVA(algorithm_spatial="IP2")
    first(X, iteration=3)
    path = tmp_path / "ip2.npz"
    first.save_state(path)
    straight = jax_models.AuxLaplaceIVA(algorithm_spatial="IP2")
    straight(X, iteration=6)

    ours = _solver(BY_ID["iva-ip2-c3"])
    ours(X, iteration=3, **state_from_jax(path, device="cpu"))
    np.testing.assert_allclose(ours.loss, straight.loss[3:], rtol=1e-9)
    np.testing.assert_allclose(_np(ours.demix_filter), np.asarray(straight.demix_filter), atol=1e-8)
    assert int(ours.step_count) == 6


def test_ilrma_resumes_jax_checkpoint_through_graph(jax_models, tmp_path):
    from audio_source_separation_tpu_torch import state_from_jax

    X = _input("mix2", seed=5)
    np.random.seed(SEED)
    ref = jax_models.GaussILRMA(n_basis=2)
    ref(X, iteration=3)
    path = tmp_path / "ilrma.npz"
    ref.save_state(path)
    ref(X, iteration=3, **jax_models.GaussILRMA.load_state(path))

    ours = _solver(BY_ID["ilrma-ip"])
    Y = ours(X, iteration=3, **state_from_jax(path, device="cpu"))
    assert len(_step_graphs(ours)) == 1
    np.testing.assert_allclose(ours.loss, ref.loss[4:], rtol=1e-9)
    np.testing.assert_allclose(_np(Y), np.asarray(ref.estimation), atol=1e-8)
    np.testing.assert_allclose(_np(ours.basis), np.asarray(ref.basis), atol=1e-8)


@pytest.mark.parametrize("case_id", ["iva-ip-c2", "iva-ip2-c3", "ilrma-ip", "fastmnmf"])
def test_callbacks_see_the_eager_loops_estimates(case_id):
    """With callbacks the graph replays once an iteration and publishes the
    state before each callback: the callbacks see what the eager loop's see,
    and what one callback keeps is not overwritten by the next replay."""
    case = BY_ID[case_id]
    X = _input(case[3])
    seen = []
    for emulate in (False, True):
        record = []
        solver = _solver(case, emulate=emulate, callbacks=lambda s: record.append((s.estimation, list(s.loss))))
        _call(solver, X)
        seen.append((record, list(solver.loss)))
    (eager, eager_loss), (graph, graph_loss) = seen
    assert eager_loss == graph_loss and len(graph) == len(eager) >= ITERATIONS
    for (a, la), (b, lb) in zip(eager, graph):
        assert la == lb and torch.equal(a, b)


class _Stub(IterativeSolver):
    """A one-field solver whose step the tests shape."""

    def __init__(self, step, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self._emulate_graph = True
        self.step = step

    def capturable(self, X):
        return True

    def init_state(self, X):
        return {"x": X.real.clone()}

    def update_state(self, state):
        return self.step(state)

    def nll(self, state):
        return state["x"].sum()

    def finalize(self, state):
        return state["x"]


def test_step_that_changes_its_fields_raises():
    grown = _Stub(lambda s: dict(s, extra=s["x"] * 2) if "extra" not in s else dict(s, more=s["x"]))
    with pytest.raises(GraphCaptureError, match="fields, shapes and dtypes"):
        grown(_input("mix2"), iteration=3)
    reshaped = _Stub(lambda s: {"x": s["x"][..., :-1]})
    with pytest.raises(GraphCaptureError, match="fields, shapes and dtypes"):
        reshaped(_input("mix2"), iteration=3)


def test_replays_add_a_captured_steps_launches():
    """A step that launches K2 once and K1 twice counts so at every
    iteration: the first eager, each replay by the bookkeeping (the capture's
    own launches are taken back)."""

    def step(state):
        fused_auxiva_ip_iter.launches += 1
        weighted_covariance_planes.launches += 2
        return {"x": state["x"] * 0.5}

    fused_auxiva_ip_iter.launches = weighted_covariance_planes.launches = 0
    solver = _Stub(step)
    Y = solver(_input("mix2"), iteration=7)
    assert (fused_auxiva_ip_iter.launches, weighted_covariance_planes.launches) == (7, 14)
    assert torch.equal(Y, torch.as_tensor(_input("mix2")).real * 0.5**7)
    assert solver.loss == [float(Y.sum() * 2 ** (7 - k)) for k in range(8)]
    solver(_input("mix2"), iteration=3)  # the cached graph
    assert (fused_auxiva_ip_iter.launches, weighted_covariance_planes.launches) == (10, 20)

    # benchmark_solver replays the step it captures: 1 eager, short = 2 once,
    # then 4 windows of 5 and of 2
    fused_auxiva_ip_iter.launches = 0
    with pytest.warns(RuntimeWarning, match="jitter"):  # a window of microseconds
        rate, _ = benchmark_solver(_Stub(step), _input("mix2"), iteration=5, short=2)
    assert rate > 0 and fused_auxiva_ip_iter.launches == 1 + 2 + 4 * 5 + 4 * 2


def test_batch_separate_captures_once():
    """Every member of a batch replays the one graph of its shape and
    equals its own call."""
    batch = np.stack([_input("mix2", seed=s) for s in range(3)])
    solver = _solver(BY_ID["ilrma-ip"])
    np.random.seed(SEED)
    outputs, losses = batch_separate(solver, batch, iteration=4)
    assert len(_step_graphs(solver)) == 1
    np.random.seed(SEED)
    draws = [solver.prepare_state_kwargs(torch.as_tensor(x), {}) for x in batch]
    for b, x in enumerate(batch):
        own = _solver(BY_ID["ilrma-ip"], emulate=False)
        Y = own(x, iteration=4, **draws[b])
        np.testing.assert_array_equal(outputs[b], _np(Y))
        np.testing.assert_array_equal(losses[b], own.loss[1:])


# the classes of the slice, each capturable in these configurations and
# not in the others listed (on a two-channel input)
CAPTURABLE = [
    ("AuxLaplaceIVA", {}), ("AuxLaplaceIVA", {"guard": "none"}), ("AuxLaplaceIVA", {"algorithm_spatial": "ISS"}),
    ("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}), ("AuxLaplaceIVA", {"algorithm_spatial": "ISS", "guard": "svd"}),
    ("AuxGaussIVA", {}), ("AuxGaussIVA", {"algorithm_spatial": "ISS"}),
    ("GaussILRMA", {}), ("GaussILRMA", {"algorithm_spatial": "ISS"}), ("GaussILRMA", {"algorithm_spatial": "IP2"}),
    ("TILRMA", {}), ("ConsistentGaussILRMA", {"fft_size": 64}), ("FastMultichannelISNMF", {}),
    ("EUCNMF", {}), ("KLNMF", {}), ("ISNMF", {}), ("TNMF", {}), ("CauchyNMF", {}), ("ComplexEUCNMF", {}),
    ("EUCNTF", {}),
    ("OverAuxLaplaceIVA", {"algorithm_spatial": "IP"}), ("GradLaplaceIVA", {}), ("NaturalGradLaplaceIVA", {}),
    ("GaussIDLMA", {"jax_dnn": True}), ("MultichannelISNMF", {}), ("MultichannelISNMF", {"author": "Ozerov"}),
    ("CovarianceISNMF", {}), ("GaussIPSDTA", {}), ("GaussIPSDTA", {"author": "Ikeshita"}), ("TIPSDTA", {}),
    ("LDPSDTF", {}), ("LDPSDTF", {"n_basis": 3}), ("GradLaplaceFDICA", {}), ("NaturalGradLaplaceFDICA", {}),
    ("ProxLaplaceIVA", {}),
]
EAGER = [
    ("AuxLaplaceIVA", {"guard": "svd"}), ("AuxLaplaceIVA", {"algorithm_spatial": "IP2", "guard": "svd"}),
    ("AuxGaussIVA", {"algorithm_spatial": "IP2"}), ("GaussILRMA", {"guard": "svd"}), ("TILRMA", {"guard": "svd"}),
    ("FastMultichannelISNMF", {"guard": "svd"}), ("OverAuxLaplaceIVA", {"algorithm_spatial": "IP", "guard": "svd"}),
    ("GaussIDLMA", {}), ("GaussIDLMA", {"jax_dnn": True, "guard": "svd"}),
]


def test_capturable_is_exactly_the_slice():
    def make(name, kwargs):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return getattr(port_models, name)(device="cpu", **kwargs)

    X = torch.zeros((2, 3, 4), dtype=torch.complex128)
    assert all(make(n, k).capturable(X) for n, k in CAPTURABLE)
    assert not any(make(n, k).capturable(X) for n, k in EAGER)
    solvers = {n for n, _ in CAPTURABLE + EAGER}
    iterative = {
        n for n in port_models.__all__ if isinstance(getattr(port_models, n), type)
        and issubclass(getattr(port_models, n), IterativeSolver)
    }
    # every iterative model is classified, but the stubs that raise at init,
    # a base class and the aliases
    assert iterative - solvers == {
        "SparseAuxIVA", "MultichanneltNMF", "GGDILRMA", "KLILRMA", "RegularizedILRMA", "SparseProxIVA", "PDSBSSBase",
        "tILRMA", "tNMF", "tIPSDTA",
    }
    solver = make("AuxLaplaceIVA", {})
    solver._emulate_graph = True
    assert solver._uses_graph(X) and not make("AuxLaplaceIVA", {})._uses_graph(X)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the card's cases: each family of the slice at 2 x 257 x 469 (C = 3 for
# K1's (N, T) weights)
CARD_CASES = [
    "iva-ip-c2", "gauss-iva-ip-c2", "iva-ip-c3", "iva-ip-c5", "iva-iss", "iva-ip2-c3", "ilrma-ip", "ilrma-iss",
    "ilrma-ip2", "tilrma", "consistent-ilrma", "fastmnmf", "eucnmf", "isnmf-mm", "cauchy-mm-fast",
    "complex-eucnmf", "eucntf",
]


@pytest.mark.cuda
@pytest.mark.parametrize("case_id", CARD_CASES)
def test_graph_equals_eager_on_card(cuda, case_id):
    """The captured loop against the eager one on the card, from the same
    draws: bit for bit (K2's path; the rest too, the same kernels and
    cuBLAS calls replayed); one capture across two calls."""
    _, name, kwargs, kind = BY_ID[case_id]
    X = _input(kind, F=257, T=469)
    results = []
    for eager in (True, False):
        solver = getattr(port, name)(device="cuda", **kwargs)
        np.random.seed(SEED)
        out = solver._eager_call(X, iteration=10) if eager else solver(X, iteration=10)
        results.append((_parts(out), list(solver.loss), solver))
    (Y0, L0, _), (Y1, L1, graph) = results
    assert L0 == L1
    _assert_same(Y0, Y1)
    np.random.seed(SEED)
    graph(X, iteration=3)
    assert len(_step_graphs(graph)) == 1


@pytest.mark.cuda
def test_step_with_a_host_read_raises_on_card(cuda):
    """A step that reads a value on the host, declared capturable, raises
    naming the line; it does not fall back to the eager loop."""
    solver = _Stub(lambda s: {"x": s["x"] * s["x"].abs().max().item()})
    solver.device = cuda
    with pytest.raises(GraphCaptureError, match="item"):
        solver(_input("mix2"), iteration=3)
    assert not solver._graph_cache
    torch.cuda.synchronize()
    assert torch.equal(torch.ones(3, device=cuda) * 2, torch.full((3,), 2.0, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k2-gauss", "k1", "k1-per-bin", "k1-split"])
def test_kernels_replayed_in_a_graph_equal_eager(cuda, kernel):
    """K1 and K2 captured and replayed equal their eager launches bit for
    bit, each launch counted once a replay."""
    rng = np.random.RandomState(7)
    C, F, T = (3, 2049, 469) if kernel == "k1" else ((2, 129, 7001) if kernel == "k1-split" else (2, 2049, 469))
    X = torch.as_tensor((rng.randn(C, F, T) + 1j * rng.randn(C, F, T)).astype(np.complex64), device=cuda)
    if kernel.startswith("k2"):
        W = torch.as_tensor(
            (np.eye(2)[:, :, None] + 0.1 * (rng.randn(2, 2, F) + 1j * rng.randn(2, 2, F))).astype(np.complex64),
            device=cuda,
        )
        psum = (X.abs() ** 2).sum(dim=1).contiguous()
        contrast = "gauss" if kernel == "k2-gauss" else "laplace"
        counter = fused_auxiva_ip_iter

        def step(state):
            Wn, p, _, nll = fused_auxiva_ip_iter(X, state["W"], state["psum"], contrast=contrast)
            return {"W": Wn, "psum": p, "nll": nll.reshape(1)}

        state = {"W": W, "psum": psum, "nll": psum.new_zeros(1)}
    else:
        shape = (C, F, T) if kernel != "k1" else (C, T)
        w = torch.as_tensor((np.abs(rng.randn(*shape)) + 0.1).astype(np.float32), device=cuda)
        counter = weighted_covariance_planes

        def step(state):
            return {"U": weighted_covariance_planes(X, state["w"]), "w": state["w"] * 1.0}

        state = {"w": w, "U": weighted_covariance_planes(X, w)}
    expected = [step(state)]
    for _ in range(2):
        expected.append(step(expected[-1]))
    stream = new_stream(cuda)
    with on_stream(stream):
        first = step(state)
        graph = StepGraph("kernel", first, step, stream=stream)
    before = counter.launches
    graph.replay(2)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    for k, v in expected[2].items():
        assert torch.equal(graph.static[k], v), k

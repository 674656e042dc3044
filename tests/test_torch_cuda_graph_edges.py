"""The captured edges of a solver call on the card: a cached AuxIVA call
replays its init and finalize graphs beside the step's, and equals the
eager loop bit for bit.

Needs an NVIDIA GPU; each test skips without one.  This file imports
neither JAX nor ``conftest``:

    python -m pytest tests/test_torch_cuda_graph_edges.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.parallel import batch_separate
from audio_source_separation_tpu_torch.runtime.spanlog import counters

ITERATION = 50
COUNTERS = ("graph_captures", "graph_cache_hits", "graph_replays", "edge_graph_captures", "edge_graph_replays",
            "host_copies")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mixture(C, F, T, seed):
    """A seeded complex64 mixture on the card: two sources through a random
    2 x 2 (C x C) mix per bin, so the solver has something to separate."""
    rng = np.random.RandomState(seed)
    S = rng.laplace(size=(C, F, T)) * np.exp(2j * np.pi * rng.rand(C, F, T))
    A = np.eye(C)[None] + 0.5 * (rng.randn(F, C, C) + 1j * rng.randn(F, C, C))
    X = np.einsum("fcd,dft->cft", A, S)
    return torch.as_tensor(X.astype(np.complex64), device="cuda")


def _counted(fn):
    before = dict(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: counters[k] - before[k] for k in COUNTERS}


def _assert_equals_eager(cls, kwargs, X, solver, Y):
    eager = cls(device="cuda", **kwargs)
    Y_eager = eager._eager_call(X, iteration=ITERATION)
    assert torch.equal(Y, Y_eager)
    assert solver.loss == eager.loss
    assert torch.equal(solver.demix_filter, eager.demix_filter)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [939, 57, 150], ids=["song_60s", "clip_57", "clip_150"])
def test_cached_call_replays_its_edges(cuda, T):
    """The main path at a 60 s song's and two clips' frame counts: a cached
    call replays 2 edges and 49 steps and captures nothing, equals the
    eager loop bit for bit, copies once to the host, and leaves what an
    earlier call returned as it was."""
    cls, kwargs = port.AuxLaplaceIVA, {"algorithm_spatial": "IP"}
    solver = cls(device="cuda", **kwargs)
    X1, X2, X3 = (_mixture(2, 1025, T, seed) for seed in (1, 2, 3))
    _, first = _counted(lambda: solver(X1, iteration=ITERATION))
    assert first["graph_captures"] == 1 and first["edge_graph_captures"] == 2 and first["edge_graph_replays"] == 2
    solver.loss = []
    Y2, second = _counted(lambda: solver(X2, iteration=ITERATION))
    assert second == {"graph_captures": 0, "graph_cache_hits": 1, "graph_replays": ITERATION - 1,
                      "edge_graph_captures": 0, "edge_graph_replays": 2, "host_copies": 1}
    assert len(solver.loss) == ITERATION + 1 and np.all(np.isfinite(solver.loss))
    _assert_equals_eager(cls, kwargs, X2, solver, Y2)
    held = [Y2.clone(), solver.demix_filter.clone()]
    Y2_ref, W2_ref = Y2, solver.demix_filter
    solver.loss = []
    Y3, third = _counted(lambda: solver(X3, iteration=ITERATION))
    assert third["edge_graph_replays"] == 2 and third["graph_captures"] == 0
    assert torch.equal(Y2_ref, held[0]) and torch.equal(W2_ref, held[1])
    assert not torch.equal(Y3, Y2_ref)
    _assert_equals_eager(cls, kwargs, X3, solver, Y3)


@pytest.mark.cuda
def test_lengths_in_turn_share_one_pool(cuda):
    """One solver over frame counts in turn (A, B, A, C, B): the edge
    graphs of every length share one memory pool, and each call still
    equals the eager loop bit for bit."""
    cls, kwargs = port.AuxLaplaceIVA, {}
    solver = cls(device="cuda", **kwargs)
    for T, seed in ((57, 10), (150, 11), (57, 12), (939, 13), (150, 14)):
        solver.loss = []
        X = _mixture(2, 1025, T, seed)
        Y, delta = _counted(lambda: solver(X, iteration=ITERATION))
        assert delta["edge_graph_replays"] == 2
        _assert_equals_eager(cls, kwargs, X, solver, Y)
    entries = solver._graph_cache.values()
    assert len(entries) == 3 and all(entry.init is not None and len(entry.steps) == 1 for entry in entries)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cls, kwargs, C",
    [
        (port.AuxGaussIVA, {}, 2),
        (port.AuxLaplaceIVA, {}, 3),
        (port.AuxGaussIVA, {}, 3),
        (port.AuxLaplaceIVA, {}, 4),
        (port.AuxGaussIVA, {}, 4),
        (port.AuxLaplaceIVA, {"guard": "none"}, 2),
    ],
    ids=["gauss-c2", "laplace-c3", "gauss-c3", "laplace-c4", "gauss-c4", "laplace-none-c2"],
)
def test_every_opted_in_configuration_equals_eager(cuda, cls, kwargs, C):
    """The other configurations that capture their edges (component IP at
    C <= 4), a cached call bit for bit the eager loop's."""
    solver = cls(device="cuda", **kwargs)
    solver(_mixture(C, 257, 469, 4), iteration=ITERATION)
    solver.loss = []
    X = _mixture(C, 257, 469, 5)
    Y, delta = _counted(lambda: solver(X, iteration=ITERATION))
    assert delta["edge_graph_replays"] == 2 and delta["graph_replays"] == ITERATION - 1
    assert delta["graph_captures"] == delta["edge_graph_captures"] == 0
    _assert_equals_eager(cls, kwargs, X, solver, Y)


@pytest.mark.cuda
def test_overdetermined_and_batch_equal_eager(cuda):
    """OverAuxLaplaceIVA (4 mics to 2 sources) through its entry point, and
    ``batch_separate`` of AuxLaplaceIVA, against their eager loops."""
    X = _mixture(4, 257, 469, 6)
    over = port.OverAuxLaplaceIVA("IP", n_sources=2, device="cuda")
    Y, delta = _counted(lambda: over(X, iteration=ITERATION))
    assert delta["edge_graph_replays"] == 2
    eager = port.OverAuxLaplaceIVA("IP", n_sources=2, device="cuda")
    eager.capturable = lambda X: False
    assert torch.equal(Y, eager(X, iteration=ITERATION)) and over.loss == eager.loss

    batch = torch.stack([_mixture(2, 257, 469, s) for s in (7, 8, 9)])
    solver = port.AuxLaplaceIVA(device="cuda")
    (outputs, losses), delta = _counted(lambda: batch_separate(solver, batch, iteration=ITERATION, host=False))
    assert delta["edge_graph_replays"] == 6 and delta["graph_captures"] == 1
    for b in range(3):
        own = port.AuxLaplaceIVA(device="cuda")
        assert torch.equal(outputs[b], own._eager_call(batch[b], iteration=ITERATION))
        assert losses[b].cpu().tolist() == own.loss[1:]

"""The captured edges of a solver call (``runtime/graph.py``:
``EdgeRoute``, ``Graph``) on the CPU at float64.

``solver._emulate_graph = True`` runs the static-buffer path, each replay of
the step, the init or the finalize an eager call of its body.  AuxIVA in
its component state opts in (``capturable_edges``): a call with no
callbacks and no warm start replays its init and finalize graphs, and must
equal the eager loop bit for bit.  Every other call keeps the path it had.
The card's side is ``tests/test_torch_cuda_graph_edges.py``.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.ops import COUNTED_KERNELS
from audio_source_separation_tpu_torch.parallel import batch_separate
from audio_source_separation_tpu_torch.runtime import graph
from audio_source_separation_tpu_torch.runtime.graph import GraphCaptureError
from audio_source_separation_tpu_torch.runtime.spanlog import counters

ITERATION = 6
COUNTERS = ("graph_captures", "graph_cache_hits", "graph_replays", "edge_graph_captures", "edge_graph_replays")


def _mixture(C=2, F=33, T=40, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(C, F, T) + 1j * rng.randn(C, F, T)


def _solver(cls=port.AuxLaplaceIVA, emulate=True, **kwargs):
    solver = cls(device="cpu", **kwargs)
    solver._emulate_graph = emulate
    return solver


def _counted(fn):
    """``fn()`` and the change of the captured loop's counters over it."""
    before = dict(counters)
    out = fn()
    return out, {k: counters[k] - before[k] for k in COUNTERS}


def _same(solver, eager, Y, Y_eager):
    assert torch.equal(Y, Y_eager)
    assert solver.loss == eager.loss
    assert torch.equal(solver.demix_filter, eager.demix_filter)
    assert torch.equal(solver.estimation, eager.estimation)


def _statics(solver):
    """Every static buffer of the solver's graphs: the step graphs', the
    edges' input and the init and finalize graphs' outputs."""
    out = []
    for entry in solver._graph_cache.values():
        out += [t for g in entry.steps.values() for t in g.static.values()]
        out.append(entry.input)
        out += [t for t in torch.utils._pytree.tree_leaves(entry.init.outputs)]
        out += [t for t in torch.utils._pytree.tree_leaves(entry.finalize.outputs)]
    return out


@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("cls", [port.AuxLaplaceIVA, port.AuxGaussIVA], ids=["laplace", "gauss"])
def test_edges_equal_the_eager_call(cls, C):
    """The output, the losses and the published filter bit for bit the
    eager loop's, on the call that captures and on a cached one; 2 edge
    replays a call, the step's counters as without the edges."""
    X1, X2 = _mixture(C, seed=1), _mixture(C, seed=2)
    solver, eager = _solver(cls), _solver(cls, emulate=False)
    Y1, first = _counted(lambda: solver(X1, iteration=ITERATION))
    _same(solver, eager, Y1, eager._eager_call(X1, iteration=ITERATION))
    assert first == {"graph_captures": 1, "graph_cache_hits": 0, "graph_replays": ITERATION - 1,
                     "edge_graph_captures": 2, "edge_graph_replays": 2}
    Y2, second = _counted(lambda: solver(X2, iteration=ITERATION))
    _same(solver, eager, Y2, eager._eager_call(X2, iteration=ITERATION))
    assert second == {"graph_captures": 0, "graph_cache_hits": 1, "graph_replays": ITERATION - 1,
                      "edge_graph_captures": 0, "edge_graph_replays": 2}
    (entry,) = solver._graph_cache.values()
    assert len(entry.steps) == 1 and entry.init is not None


def test_the_step_graph_reads_the_init_graphs_input():
    """X is copied once a call: the step graph's static input is the init
    graph's, which the finalize graph reads too."""
    solver = _solver()
    solver(_mixture(), iteration=ITERATION)
    (entry,) = solver._graph_cache.values()
    (graph,) = entry.steps.values()
    assert graph.static["input"] is entry.input is entry.init.outputs[0]["input"]
    assert entry.finalized is graph and entry.finalize.inputs == (graph.static,)


def test_nothing_a_caller_holds_aliases_a_static_buffer():
    """The output and every published tensor of a call are its own: a
    later call, which refills the static buffers, leaves them as they
    were."""
    solver = _solver()
    X = _mixture(seed=3)
    Y = solver(X, iteration=ITERATION)
    held = [Y] + [v for v in vars(solver).values() if isinstance(v, torch.Tensor)]
    copies = [t.clone() for t in held]
    solver(_mixture(seed=4), iteration=ITERATION)
    storages = {t.untyped_storage().data_ptr() for t in _statics(solver)}
    for t, c in zip(held, copies):
        assert torch.equal(t, c)
        assert t.untyped_storage().data_ptr() not in storages
    assert torch.equal(solver.input, torch.as_tensor(_mixture(seed=4)))


def test_shapes_a_b_a_key_the_call():
    """One solver over shapes A, B, A: the attributes init sets follow each
    call, each shape keys its own edges, and A's come back from the
    cache."""
    A, B = _mixture(T=40, seed=5), _mixture(T=23, seed=6)
    solver, eager = _solver(), _solver(emulate=False)
    for X, T, captures in ((A, 40, 2), (B, 23, 2), (A, 40, 0)):
        Y, delta = _counted(lambda: solver(X, iteration=ITERATION))
        _same(solver, eager, Y, eager._eager_call(X, iteration=ITERATION))
        assert solver.n_frames == T and solver.n_bins == 33 and solver.n_sources == 2
        assert delta["edge_graph_captures"] == captures and delta["edge_graph_replays"] == 2
        (key,) = [k for k in solver._graph_cache if k[0] == X.shape]
        assert ("n_frames", T) in key[3]
    assert sorted(key[0] for key in solver._graph_cache) == [(2, 33, 23), (2, 33, 40)]
    assert sum(len(entry.steps) for entry in solver._graph_cache.values()) == 2


@pytest.mark.parametrize(
    "case",
    ["warm_start", "callbacks", "iss", "ip2", "svd", "c5", "no_iteration", "gradient", "ilrma"],
)
def test_other_calls_keep_their_path(case):
    """A warm start, callbacks, ISS, IP2, the ``svd`` guard, C = 5, no
    iteration and the families that do not opt in replay no edge and equal
    the eager loop as before."""
    X = _mixture(5 if case == "c5" else 2, seed=7)
    kwargs, call, iteration = {}, {}, ITERATION
    cls = port.AuxLaplaceIVA
    if case == "warm_start":
        rng = np.random.RandomState(8)
        call = {"demix_filter": np.eye(2)[None] + 0.1 * rng.randn(33, 2, 2)}
    elif case == "callbacks":
        kwargs = {"callbacks": lambda s: None}
    elif case in ("iss", "ip2"):
        kwargs = {"algorithm_spatial": case.upper()}
    elif case == "svd":
        kwargs = {"guard": "svd"}
    elif case == "no_iteration":
        iteration = 0
    elif case == "gradient":
        cls = port.GradLaplaceIVA
    elif case == "ilrma":
        cls, kwargs = port.GaussILRMA, {"n_basis": 2}
    solver, eager = _solver(cls, **kwargs), _solver(cls, emulate=False, **kwargs)
    np.random.seed(0)
    Y, delta = _counted(lambda: solver(X, iteration=iteration, **call))
    np.random.seed(0)
    Y_eager = eager._eager_call(X, iteration=iteration, **call)
    assert torch.equal(Y, Y_eager) and solver.loss == eager.loss
    assert delta["edge_graph_replays"] == delta["edge_graph_captures"] == 0
    assert not any(entry.init for entry in vars(solver).get("_graph_cache", {}).values())


def test_without_the_loss_recorded():
    X = _mixture(seed=9)
    solver, eager = _solver(recordable_loss=False), _solver(emulate=False, recordable_loss=False)
    for _ in range(2):
        Y, delta = _counted(lambda: solver(X, iteration=ITERATION))
        assert torch.equal(Y, eager._eager_call(X, iteration=ITERATION))
        assert solver.loss is None and delta["edge_graph_replays"] == 2
    (entry,) = solver._graph_cache.values()
    assert entry.init.outputs[1] == []


def test_one_iteration():
    X = _mixture(seed=10)
    solver, eager = _solver(), _solver(emulate=False)
    for _ in range(2):
        Y, delta = _counted(lambda: solver(X, iteration=1))
        _same(solver, eager, Y, eager._eager_call(X, iteration=1))
        assert delta["edge_graph_replays"] == 2 and delta["graph_replays"] == 0


def test_overdetermined_solver_on_its_reduced_mixture():
    """OverAuxLaplaceIVA inherits the opt-in: its call's PCA and outer
    projection-back stay eager around the captured edges."""
    X = _mixture(4, seed=11)
    solver = _solver(port.OverAuxLaplaceIVA, algorithm_spatial="IP", n_sources=2)
    eager = _solver(port.OverAuxLaplaceIVA, emulate=False, algorithm_spatial="IP", n_sources=2)
    for _ in range(2):
        Y, delta = _counted(lambda: solver(X, iteration=ITERATION))
        # the eager side through the same entry point, its PCA included
        assert torch.equal(Y, eager(X, iteration=ITERATION)) and solver.loss == eager.loss
        assert delta["edge_graph_replays"] == 2


def test_batch_members_replay_the_edges():
    """``batch_separate`` of AuxIVA: each member replays the init and the
    finalize graph and equals its own eager call."""
    batch = np.stack([_mixture(seed=s) for s in range(3)])
    solver = _solver()
    (outputs, losses), delta = _counted(lambda: batch_separate(solver, batch, iteration=4))
    assert delta["edge_graph_replays"] == 6 and delta["edge_graph_captures"] == 2 and delta["graph_captures"] == 1
    for b, x in enumerate(batch):
        own = _solver(emulate=False)
        Y = own._eager_call(x, iteration=4)
        np.testing.assert_array_equal(outputs[b], Y.numpy())
        np.testing.assert_array_equal(losses[b], own.loss[1:])


@pytest.mark.parametrize(
    "cls, kwargs, C, route",
    [
        (port.AuxLaplaceIVA, {}, 2, "EdgeRoute"),
        (port.GaussILRMA, {"n_basis": 2}, 2, "StepRoute"),
        (port.ProxLaplaceIVA, {}, 3, "Route"),
    ],
    ids=["edges", "step", "eager"],
)
def test_a_batch_member_takes_its_own_calls_route(monkeypatch, cls, kwargs, C, route):
    """A ``batch_separate`` member and its own ``solver(X)`` call take one
    route, chosen in one place, with the same captures, replays and kernel
    launches."""
    taken = []
    made = graph.Route.__init__

    def record(self, *args):
        taken.append(type(self).__name__)
        made(self, *args)

    monkeypatch.setattr(graph.Route, "__init__", record)
    names = ("graph_captures", "graph_replays", "edge_graph_replays")

    def counted(fn):
        before = [counters[k] for k in names] + [k.launches for k in COUNTED_KERNELS]
        fn()
        after = [counters[k] for k in names] + [k.launches for k in COUNTED_KERNELS]
        return [a - b for a, b in zip(after, before)]

    X = _mixture(C, seed=12)
    np.random.seed(0)
    own = counted(lambda: _solver(cls, **kwargs)(X, iteration=ITERATION))
    np.random.seed(0)
    member = counted(lambda: batch_separate(_solver(cls, **kwargs), X[None], iteration=ITERATION))
    assert taken == [route, route]
    assert member == own


class _HostReadInInit(port.AuxLaplaceIVA):
    def init_state(self, X, **kwargs):
        state = super().init_state(X, **kwargs)
        return dict(state, psum=state["psum"] * state["psum"].abs().max().item())


class _HostReadInFinalize(port.AuxLaplaceIVA):
    def finalize(self, state):
        Y = super().finalize(state)
        return Y * float(Y.abs().max())


@pytest.mark.parametrize("cls, edge", [(_HostReadInInit, "init"), (_HostReadInFinalize, "finalize")])
def test_a_host_read_in_an_edge_raises(cls, edge):
    """A host read in an opted-in edge raises naming the edge and the line,
    under the audit that stands for a capture; it does not fall back."""
    solver = _solver(cls)
    message = "declares its {} capturable, but capture failed at .*test_torch_graph_edges.py.*_local_scalar_dense"
    for _ in range(2):  # and again: nothing half-made is cached
        with pytest.raises(GraphCaptureError, match=message.format(edge)):
            solver(_mixture(), iteration=ITERATION)

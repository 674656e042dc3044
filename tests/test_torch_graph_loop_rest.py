"""The captured loop (``runtime/graph.py``) for the families whose steps
became capturable with K3 and the capture audit, on the CPU at float64:
the gradient IVAs and FDICAs, OverAuxLaplaceIVA, ProxLaplaceIVA at C = 2,
MNMF (Sawada, Ozerov), CovarianceISNMF, GaussIDLMA with ``jax_dnn=True``,
the block-PSD models on every source route, and LDPSDTF.

As in ``test_torch_graph_loop.py`` (whose helpers this file shares),
``solver._emulate_graph = True`` runs the runner's static-buffer path, each
replay an eager step, and the one run in place of the capture under the
capture audit (``runtime/graph.py::CaptureAudit``): the graph must equal
the eager loop bit for bit, and each family's main path the JAX package's
loss trajectory at rtol 1e-9.

The ``cuda`` tests need a card; this file imports JAX only inside the JAX
tests, so on a machine without JAX they run with

    python -m pytest tests/test_torch_graph_loop_rest.py --noconftest -q -m cuda
"""

import warnings

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import models as port_models
from audio_source_separation_tpu_torch.ops.cov_kernel import weighted_covariance_planes
from audio_source_separation_tpu_torch.ops.fused_ip import fused_auxiva_ip_iter
from audio_source_separation_tpu_torch.ops.eigh_kernel import SHARED_N, batched_eigh
from audio_source_separation_tpu_torch.runtime.graph import GraphCaptureError

from chip_smoke import VarianceMLP
from test_torch_graph_loop import (
    CAPTURABLE,
    ITERATIONS,
    SEED,
    _assert_same,
    _input,
    _parts,
    _published,
    _step_graphs,
    _Stub,
)

HIDDEN = 8


def _input_rest(kind, seed=0, F=33, T=40):
    """``_input``'s kinds, and the covariance targets ``(F, T, C, C)``
    ("cov2", "cov3") and a Gram target ``(B, B, T)`` of 8 taps ("gram")."""
    if kind.startswith("cov"):
        X = _input("mix" + kind[3:], seed=seed, F=17, T=20)
        return np.einsum("cft,dft->ftcd", X, X.conj()) + 0.01 * np.eye(X.shape[0])
    if kind == "gram":
        rng = np.random.RandomState(seed)
        bases = [rng.randn(8, 8) for _ in range(3)]
        stacked = np.stack([a @ a.T + 0.5 * np.eye(8) for a in bases])
        return np.einsum("kij,kt->ijt", stacked, np.abs(rng.randn(3, 24)) + 0.2)
    return _input(kind, seed=seed, F=F, T=T)


def _mlp_weights(n_bins=33):
    r = np.random.RandomState(3)
    return r.randn(HIDDEN, n_bins) * 0.3, r.randn(n_bins, HIDDEN) * 0.3


NETWORK = port.torch_dnn(VarianceMLP(*_mlp_weights()))
KONDO, IKESHITA = {"n_basis": 2, "n_blocks": 11}, {"n_basis": 2, "n_blocks": 11, "author": "Ikeshita"}
PLANES, PENCIL = {"source_compact": False}, {"source_pencil": True}
# (id, class, kwargs, route switches, input kind, call kwargs)
CASES = [
    ("grad-iva", "GradLaplaceIVA", {}, {}, "mix2", {}),
    ("natgrad-iva", "NaturalGradLaplaceIVA", {}, {}, "mix2", {}),
    ("grad-fdica", "GradLaplaceFDICA", {}, {}, "mix2", {}),
    ("natgrad-fdica", "NaturalGradLaplaceFDICA", {}, {}, "mix2", {}),
    ("over-iva-4to2", "OverAuxLaplaceIVA", {"algorithm_spatial": "IP", "n_sources": 2}, {}, "mix4", {}),  # K2's plain
    ("prox-c2", "ProxLaplaceIVA", {}, {}, "mix2", {}),
    ("sawada-c2", "MultichannelISNMF", {"n_basis": 2}, {}, "mix2", {}),
    ("sawada-c3", "MultichannelISNMF", {"n_basis": 2}, {}, "mix3", {}),  # the matrix Riccati, K3
    ("ozerov-c2", "MultichannelISNMF", {"n_basis": 2, "author": "Ozerov"}, {}, "mix2", {}),
    ("ozerov-c3", "MultichannelISNMF", {"n_basis": 2, "author": "Ozerov"}, {}, "mix3", {}),
    ("ozerov-anneal-c2", "MultichannelISNMF", {"n_basis": 2, "author": "Ozerov", "annealing": True}, {}, "mix2", {}),
    ("cov-isnmf-c2", "CovarianceISNMF", {"n_basis": 2}, {}, "cov2", {}),
    ("cov-isnmf-c3", "CovarianceISNMF", {"n_basis": 2}, {}, "cov3", {}),  # K3
    ("idlma-mlp-c2", "GaussIDLMA", {"jax_dnn": True}, {}, "mix2", {"dnn": NETWORK}),  # K1 per bin
    ("idlma-mlp-c3", "GaussIDLMA", {"jax_dnn": True}, {}, "mix3", {"dnn": NETWORK}),
    ("kondo-b3", "GaussIPSDTA", KONDO, {}, "mix2", {}),  # K1 per bin, K3
    ("kondo-b6", "GaussIPSDTA", dict(KONDO, n_blocks=6), {}, "mix2", {}),  # the matrix route
    ("kondo-c3", "GaussIPSDTA", KONDO, {}, "mix3", {}),
    ("ikeshita-b3", "GaussIPSDTA", IKESHITA, {}, "mix2", {}),
    ("ikeshita-b6", "GaussIPSDTA", dict(IKESHITA, n_blocks=6), {}, "mix2", {}),
    ("tipsdta-b3", "TIPSDTA", KONDO, {}, "mix2", {}),
    ("kondo-planes", "GaussIPSDTA", KONDO, PLANES, "mix2", {}),
    ("ikeshita-planes", "GaussIPSDTA", IKESHITA, PLANES, "mix2", {}),
    ("kondo-pencil", "GaussIPSDTA", KONDO, PENCIL, "mix2", {}),
    ("tipsdta-pencil", "TIPSDTA", KONDO, PENCIL, "mix2", {}),
    ("ldpsdtf-k2", "LDPSDTF", {"n_basis": 2}, {}, "gram", {}),
    ("ldpsdtf-k3", "LDPSDTF", {"n_basis": 3}, {}, "gram", {}),
]
IDS = [c[0] for c in CASES]
BY_ID = {c[0]: c for c in CASES}
# each newly captured family's main path, held to the JAX package
JAX_CASES = ["idlma-mlp-c2", "ozerov-c2", "kondo-b3", "ldpsdtf-k2", "grad-fdica"]


def _solver(case, emulate=True, package=port, **extra):
    _, name, kwargs, switches, _, _ = case
    more = {} if package is not port else {"device": "cpu"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # Ozerov's "in progress"
        solver = getattr(package, name)(**kwargs, **more, **extra)
    for switch, value in switches.items():
        setattr(solver, switch, value)
    if package is port:
        solver._emulate_graph = emulate
    return solver


def _call(solver, case, X, iteration=ITERATIONS, seed=SEED):
    np.random.seed(seed)  # the host draws of prepare_state_kwargs
    return solver(X, iteration=iteration, **case[5])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graph_equals_eager_loop(case):
    """Losses, output and published state bit for bit the eager loop's, one
    graph in the cache, the step through the capture audit."""
    X = _input_rest(case[4])
    eager, graph = _solver(case, emulate=False), _solver(case)
    Y0, Y1 = _call(eager, case, X), _call(graph, case, X)
    assert graph.capturable(X) and len(_step_graphs(graph)) == 1
    assert not vars(eager).get("_graph_cache")
    assert eager.loss == graph.loss and len(graph.loss) == ITERATIONS + graph.record_initial_loss
    _assert_same(_parts(Y0), _parts(Y1))
    _assert_same(list(_published(eager).values()), list(_published(graph).values()))


def _jax_mlp(W1, W2):
    import jax
    import jax.numpy as jnp

    W1, W2 = jnp.asarray(W1), jnp.asarray(W2)

    def mlp(amp):  # benchmarks/run_all.py's form, as chip_smoke.VarianceMLP
        h = jax.nn.relu(jnp.einsum("hf,sft->sht", W1, amp))
        return jax.nn.softplus(jnp.einsum("fh,sht->sft", W2, h)) + 1e-3

    return mlp


@pytest.mark.parametrize("case_id", JAX_CASES)
def test_graph_matches_jax_trajectory(case_id):
    import audio_source_separation_tpu.models as jax_models

    case = BY_ID[case_id]
    X = _input_rest(case[4])
    ref = _solver(case, package=jax_models)
    call = {"dnn": _jax_mlp(*_mlp_weights())} if case[5] else {}
    np.random.seed(SEED)
    ref_out = ref(X, iteration=ITERATIONS, **call)
    ours = _solver(case)
    out = _call(ours, case, X)
    assert len(_step_graphs(ours)) == 1
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    for a, b in zip(_parts(out), ref_out if isinstance(ref_out, tuple) else (ref_out,)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-7, atol=1e-9 * np.abs(b).max())


def test_idlma_graph_is_cached_per_network():
    """The network is part of the graph's key: the same one replays its
    graph, another is captured anew and runs its own weights."""
    case = BY_ID["idlma-mlp-c2"]
    X = _input_rest("mix2")
    solver = _solver(case)
    _call(solver, case, X)
    _call(solver, case, X)
    assert len(_step_graphs(solver)) == 1
    W1, W2 = _mlp_weights()
    other = port.torch_dnn(VarianceMLP(W1 * 2, W2))
    np.random.seed(SEED)
    Y = solver(X, iteration=ITERATIONS, dnn=other)
    assert len(_step_graphs(solver)) == 2
    eager = _solver(case, emulate=False)
    np.random.seed(SEED)
    _assert_same([Y], [eager(X, iteration=ITERATIONS, dnn=other)])


# --------------------------------------------------------------------------- #
# the shape rule
# --------------------------------------------------------------------------- #
def test_shape_hook_decides_before_init():
    """ProxLaplaceIVA captures at C = 2 and keeps the eager loop at C = 3
    (its ``svd``); the eigensolve families capture past the order K3 holds
    in shared memory (its workspace route), for LDPSDTF's taps, IPSDTA's
    blocks and Sawada's channels."""
    prox = _solver(BY_ID["prox-c2"])
    X2, X3 = (torch.as_tensor(_input("mix{}".format(c))) for c in (2, 3))
    assert prox._uses_graph(X2) and not prox._uses_graph(X3)
    Y = prox(X3, iteration=3)
    assert not vars(prox).get("_graph_cache")
    eager = _solver(BY_ID["prox-c2"], emulate=False)
    _assert_same([Y], [eager(X3, iteration=3)])
    assert prox.loss == eager.loss

    ldpsdtf = _solver(BY_ID["ldpsdtf-k2"])
    for n in (SHARED_N, SHARED_N + 1):
        assert ldpsdtf._uses_graph(torch.zeros((n, n, 3)))
        one_block = _solver(("one-block", "GaussIPSDTA", dict(KONDO, n_blocks=1), {}, "mix2", {}))
        assert one_block._uses_graph(torch.zeros((2, n, 3), dtype=torch.complex128))
        sawada, ozerov = _solver(BY_ID["sawada-c3"]), _solver(BY_ID["ozerov-c3"])
        wide = torch.zeros((n, 5, 3), dtype=torch.complex128)
        assert sawada._uses_graph(wide) and ozerov._uses_graph(wide)


# --------------------------------------------------------------------------- #
# the capture audit
# --------------------------------------------------------------------------- #
HOST_READS = {
    "item": (lambda s: {"x": s["x"] * s["x"].abs().max().item()}, "_local_scalar_dense"),
    "tensor": (lambda s: {"x": s["x"] * torch.tensor([2.0], dtype=s["x"].dtype)}, "lift_fresh"),
    "eigh": (lambda s: {"x": s["x"] * torch.linalg.eigh(s["x"][0, :3, :3] + 4 * torch.eye(3))[0][0]}, "_linalg_eigh"),
}


@pytest.mark.parametrize("kind", list(HOST_READS))
def test_audit_raises_on_a_host_read(kind):
    """A step declared capturable that reads on the host raises on the CPU
    as capture does on the card, naming the op and the line."""
    step, op = HOST_READS[kind]
    solver = _Stub(step)
    with pytest.raises(GraphCaptureError, match="test_torch_graph_loop_rest.py:[0-9]+ .*aten.{}".format(op)):
        solver(_input("mix2"), iteration=3)
    assert not solver._graph_cache


def test_audit_lets_a_kernels_plain_version_through():
    """K3's plain version (``torch.linalg.eigh`` on the CPU) stands for a
    launch: the audit passes it; a step counting one K3 launch (as the
    card's wrapper does) counts one a replay."""

    def step(state):
        w = batched_eigh(state["x"][0, :3, :3] + 4 * torch.eye(3, dtype=state["x"].dtype), vectors=False)
        batched_eigh.launches += 1
        return {"x": state["x"] * (w[0] / w[0])}

    batched_eigh.launches = 0
    solver = _Stub(step)
    solver(_input("mix2"), iteration=5)
    assert len(_step_graphs(solver)) == 1 and batched_eigh.launches == 5


# an input of its kind for each class of CAPTURABLE, and its call's kwargs
AUDIT_INPUTS = {
    "MultichannelISNMF": "mix3", "CovarianceISNMF": "cov3", "LDPSDTF": "gram", "EUCNMF": "power", "KLNMF": "power",
    "ISNMF": "power", "TNMF": "power", "CauchyNMF": "power", "ComplexEUCNMF": "complex", "EUCNTF": "tensor",
    "OverAuxLaplaceIVA": "mix4", "AuxLaplaceIVA": "mix3", "AuxGaussIVA": "mix3",
}


@pytest.mark.parametrize("name,kwargs", CAPTURABLE, ids=["{}-{}".format(n, k) for n, k in CAPTURABLE])
def test_every_capturable_configuration_passes_the_audit(name, kwargs):
    kwargs = dict(kwargs)
    if name in ("GaussIPSDTA", "TIPSDTA"):
        kwargs.update(n_basis=2, n_blocks=6)
    if name in ("MultichannelISNMF", "FastMultichannelISNMF", "GaussILRMA", "TILRMA", "ConsistentGaussILRMA"):
        kwargs.setdefault("n_basis", 2)
    case = (name, name, kwargs, {}, AUDIT_INPUTS.get(name, "mix2"), {"dnn": NETWORK} if name == "GaussIDLMA" else {})
    solver = _solver(case)
    _call(solver, case, _input_rest(case[4]), iteration=2)
    assert len(_step_graphs(solver)) == 1


def test_capturable_covers_every_family():
    """Every iterative model class of the port is captured in some
    configuration (``test_torch_graph_loop.py`` lists which)."""
    names = {n for n, _ in CAPTURABLE}
    assert names >= {
        n for n in port_models.__all__
        if isinstance(getattr(port_models, n), type) and hasattr(getattr(port_models, n), "capturable")
        and n not in ("SparseAuxIVA", "MultichanneltNMF", "GGDILRMA", "KLILRMA", "RegularizedILRMA", "SparseProxIVA",
                      "PDSBSSBase", "tILRMA", "tNMF", "tIPSDTA")
    }


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def counts_zero():
    fused_auxiva_ip_iter.launches = weighted_covariance_planes.launches = batched_eigh.launches = 0


def counts():
    return fused_auxiva_ip_iter.launches, weighted_covariance_planes.launches, batched_eigh.launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graph_equals_eager_on_card(cuda, case):
    """Each family captured against its eager loop on the card at 257 x 469
    (IPSDTA's blocks as at the CPU size: B = 3 or 6), from the same draws:
    losses and output bit for bit, the kernels' launches as the eager
    loop's, one capture across two calls."""
    key, name, kwargs, switches, kind, call = case
    if "n_blocks" in kwargs:
        kwargs = dict(kwargs, n_blocks=kwargs["n_blocks"] * 8)
    X = _input_rest(kind, F=257, T=469)
    if call:
        call = {"dnn": port.torch_dnn(VarianceMLP(*_mlp_weights(257)).to(cuda))}
    results = []
    for eager in (True, False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            solver = getattr(port, name)(device="cuda", **kwargs)
        for switch, value in switches.items():
            setattr(solver, switch, value)
        if eager:  # the same entry point (OverAuxLaplaceIVA's PCA is in its __call__)
            solver.capturable = lambda X: False
        counts_zero()
        np.random.seed(SEED)
        out = solver(X, iteration=8, **call)
        torch.cuda.synchronize()
        results.append((_parts(out), list(solver.loss), counts(), solver))
    (Y0, L0, n0, _), (Y1, L1, n1, graph) = results
    assert L0 == L1 and n0 == n1
    _assert_same(Y0, Y1)
    np.random.seed(SEED)
    graph(X, iteration=3, **call)
    assert len(_step_graphs(graph)) == 1

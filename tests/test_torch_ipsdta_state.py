"""The port's IPSDTA solvers' state against the JAX package on the CPU at
float64: the seed-111 init draws (basis, activation, Ikeshita's fixed
point), warm start, callbacks, ``recordable_loss=False``, ``save_state``, a
JAX Ikeshita checkpoint resumed through ``state_from_jax`` with its
``fixed_point``, the raises, and where the covariances go: Kondo's VCD makes
exactly one call of kernel K1's wrapper per iteration with per-bin ``(S, F,
T)`` weights, on every route (the off-default source routes too), and
Ikeshita, TIPSDTA and LDPSDTF make none.
The loss trajectories are in ``test_torch_ipsdta.py``.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import state_from_jax
from audio_source_separation_tpu_torch.models import ipsdta as port_ipsdta

from _torch_port import to_np
from conftest import make_mixture

N_BASIS = 2
# solver id -> (class name, constructor kwargs, the fields a checkpoint holds)
SOLVERS = {
    "kondo": ("GaussIPSDTA", {"author": "Kondo", "spatial_iteration": 2}, {"demix_filter", "basis", "activation"}),
    "ikeshita": ("GaussIPSDTA", {"author": "Ikeshita"}, {"demix_filter", "basis", "activation", "fixed_point"}),
    "t": ("TIPSDTA", {"nu": 3.0, "spatial_iteration": 2}, {"demix_filter", "basis", "activation"}),
}


def build(package, solver, n_blocks=6, **more):
    name, kwargs, _ = SOLVERS[solver]
    if package is port:
        more.setdefault("device", "cpu")
    return getattr(package, name)(n_basis=N_BASIS, n_blocks=n_blocks, **kwargs, **more)


def mixture(n_channels=2, n_bins=12, n_frames=16, dtype=np.complex128):
    return make_mixture(np.random.RandomState(111), n_channels=n_channels, n_bins=n_bins, n_frames=n_frames, dtype=dtype)


@pytest.mark.parametrize("n_bins,n_blocks", [(12, 6), (10, 4), (13, 4)])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_init_draws_what_jax_draws(solver, n_bins, n_blocks):
    """``prepare_state_kwargs`` draws JAX's arrays in JAX's order (the
    basis blocks low then high), and the next draw after it is the same."""
    X = mixture(n_bins=n_bins)
    ref, ours = build(jax_models, solver, n_blocks=n_blocks), build(port, solver, n_blocks=n_blocks)
    np.random.seed(111)
    expected = ref.prepare_state_kwargs(X, {})
    after_ref = np.random.rand()
    np.random.seed(111)
    drawn = ours.prepare_state_kwargs(torch.as_tensor(X), {})
    assert np.random.rand() == after_ref
    assert set(drawn) == set(expected) == SOLVERS[solver][2] - {"demix_filter"}
    for field, value in expected.items():
        np.testing.assert_array_equal(np.asarray(drawn[field]), np.asarray(value).real)
        assert not np.iscomplexobj(value) or not np.asarray(value).imag.any()


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_published_init_matches_jax(solver):
    """After ``iteration=0`` both packages publish the same normalised init
    and the same first loss."""
    X = mixture(n_bins=10)
    published = []
    for package in (jax_models, port):
        solver_ = build(package, solver, n_blocks=4)
        np.random.seed(111)
        solver_(X, iteration=0)
        published.append(solver_)
    ref, ours = published
    for field in SOLVERS[solver][2]:
        np.testing.assert_allclose(to_np(getattr(ours, field)), np.asarray(getattr(ref, field)), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-12)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_warm_start_resumes_the_run(solver):
    """2 + 1 warm-started iterations equal 3 straight ones."""
    X = mixture()
    np.random.seed(111)
    first = build(port, solver)
    first(X, iteration=2)
    resumed = build(port, solver)
    Y = resumed(X, iteration=1, **{field: getattr(first, field) for field in SOLVERS[solver][2]})
    np.random.seed(111)
    straight = build(port, solver)
    Y_straight = straight(X, iteration=3)
    np.testing.assert_allclose(to_np(Y), to_np(Y_straight), atol=1e-10)
    for field in SOLVERS[solver][2]:
        np.testing.assert_allclose(to_np(getattr(resumed, field)), to_np(getattr(straight, field)), atol=1e-10)
    np.testing.assert_allclose(resumed.loss[-1], straight.loss[-1], rtol=1e-10)


def _snapshot(into, convert):
    return lambda s: into.append((convert(s.basis).copy(), convert(s.demix_filter).copy()))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each solver's JAX run of 2 iterations from the seed-111 draws, made
    once per module: the solver (its callback still set), what its callback
    saw, and its ``save_state`` checkpoint."""
    cache = {}

    def get(solver):
        if solver not in cache:
            seen = []
            np.random.seed(111)
            ref = build(jax_models, solver, callbacks=_snapshot(seen, np.asarray))
            ref(mixture(), iteration=2)
            path = tmp_path_factory.mktemp("jax") / "{}.npz".format(solver)
            ref.save_state(path)
            cache[solver] = (ref, list(seen), path)
        return cache[solver]

    return get


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_callbacks_see_each_iteration(jax_runs, solver):
    """Callbacks run after init and after every iteration and see the basis
    and filter that JAX's do."""
    ref, seen_ref, _ = jax_runs(solver)
    seen = []
    np.random.seed(111)
    ours = build(port, solver, callbacks=_snapshot(seen, to_np))
    ours(mixture(), iteration=2)
    assert len(seen) == len(seen_ref) == 3
    for ours_, ref_ in zip(seen, seen_ref):
        for a, b in zip(ours_, ref_):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours.loss, ref.loss[:3], rtol=1e-9)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_recordable_loss_off(solver):
    """``recordable_loss=False`` keeps no loss and gives the recorded run's
    output."""
    X = mixture()
    np.random.seed(111)
    quiet = build(port, solver, recordable_loss=False)
    Y = quiet(X, iteration=2)
    np.random.seed(111)
    Y_recorded = build(port, solver)(X, iteration=2)
    assert quiet.loss is None
    np.testing.assert_allclose(to_np(Y), to_np(Y_recorded), rtol=0, atol=0)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_save_state_writes_what_jax_writes(jax_runs, tmp_path, solver):
    """``save_state`` writes JAX's checkpoint after the same run, and
    ``load_state`` resumes it onto the straight run."""
    X = mixture()
    np.random.seed(111)
    ours = build(port, solver)
    ours(X, iteration=2)
    ours.save_state(tmp_path / "port.npz")
    loaded = ours.load_state(tmp_path / "port.npz")
    expected = jax_models.GaussIPSDTA.load_state(jax_runs(solver)[2])
    assert set(loaded) == set(expected) == SOLVERS[solver][2] | {"estimation"}
    for field, value in expected.items():
        np.testing.assert_allclose(loaded[field], value, rtol=1e-9, atol=1e-12)
    Y = build(port, solver)(X, iteration=1, **loaded)
    np.random.seed(111)
    np.testing.assert_allclose(to_np(Y), to_np(build(port, solver)(X, iteration=3)), atol=1e-10)


def test_resume_jax_ikeshita_checkpoint(jax_runs):
    """A JAX Ikeshita checkpoint (``demix_filter``, ``estimation``,
    ``basis``, ``activation``, ``fixed_point``) resumes in the port onto JAX's
    own resumed run, its ``fixed_point`` carried by ``state_from_jax``."""
    X = mixture()
    jax_solver, _, path = jax_runs("ikeshita")
    n_before = len(jax_solver.loss)
    Y_ref = jax_solver(X, iteration=2, **jax_models.GaussIPSDTA.load_state(path))

    loaded = state_from_jax(path, device="cpu")
    assert set(loaded) == SOLVERS["ikeshita"][2] | {"estimation"}
    assert all(isinstance(v, torch.Tensor) for v in loaded.values())
    ours = build(port, "ikeshita")
    Y = ours(X, iteration=2, **loaded)
    np.testing.assert_allclose(ours.loss, jax_solver.loss[n_before:], rtol=1e-9)
    np.testing.assert_allclose(to_np(Y), np.asarray(Y_ref), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(to_np(ours.fixed_point), np.asarray(jax_solver.fixed_point), rtol=1e-9, atol=1e-12)


def test_ikeshita_ignores_the_pencil_switch():
    """The pencil streams are an MM variant: Ikeshita's EM runs with it set,
    as in the JAX package."""
    model = build(port, "ikeshita")
    model.source_pencil = True
    np.random.seed(111)
    assert np.isfinite(model(mixture(), iteration=1).numpy()).all()


@pytest.mark.parametrize(
    "name,kwargs",
    [("GaussIPSDTA", {"author": "Sawada"}), ("TIPSDTA", {"author": "Ikeshita"}), ("GaussIPSDTA", {"n_bins": 3})],
    ids=["unknown-author", "t-ikeshita", "unknown-keyword"],
)
def test_constructors_raise_as_in_jax(name, kwargs):
    with pytest.raises(ValueError):
        getattr(jax_models, name)(**kwargs)
    with pytest.raises(ValueError):
        getattr(port, name)(device="cpu", **kwargs)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, each solver raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (port.GaussIPSDTA, port.TIPSDTA, port.tIPSDTA, port.LDPSDTF):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


PLANES, PENCIL = {"source_compact": False}, {"source_pencil": True}


@pytest.mark.parametrize(
    "solver,n_channels,n_bins,n_blocks,calls,switches",
    [
        ("kondo", 2, 12, 6, 3, {}),  # compact source steps, planes VCD
        ("kondo", 2, 10, 4, 3, {}),  # padded
        ("kondo", 2, 13, 4, 3, {}),  # matrix source steps and matrix VCD (B = 4)
        ("kondo", 3, 12, 4, 3, {}),  # planes VCD at C = 3 (N = 3 weight rows)
        ("kondo", 4, 12, 6, 3, {}),  # matrix VCD at C = 4
        ("kondo", 2, 12, 6, 3, PLANES),  # complex planes source steps and VCD inverses
        ("kondo", 3, 10, 4, 3, PLANES),
        ("kondo", 2, 10, 4, 3, PENCIL),  # the K = 2 pencil streams
        ("ikeshita", 2, 12, 6, 0, {}),
        ("ikeshita", 2, 13, 4, 0, {}),
        ("ikeshita", 2, 12, 6, 0, PLANES),
        ("t", 2, 12, 6, 0, {}),
        ("t", 2, 13, 4, 0, {}),
        ("t", 2, 10, 4, 0, PENCIL),
    ],
)
def test_covariance_goes_through_k1_per_bin(monkeypatch, solver, n_channels, n_bins, n_blocks, calls, switches):
    """Kondo's VCD covariances are one call of K1's wrapper per iteration,
    whatever the number of sweeps, with per-bin ``(S, F, T)`` weights,
    contiguous and of the mixture's real type as the CUDA kernel takes
    them; nothing else forms a covariance, and the other solvers call it
    never."""
    X = mixture(n_channels=n_channels, n_bins=n_bins)
    shapes = []
    wrapper = port_ipsdta.weighted_covariance_planes

    def counted(X_, weights):
        assert weights.is_contiguous() and weights.dtype == X_.real.dtype
        shapes.append(tuple(weights.shape))
        return wrapper(X_, weights)

    def forbidden(*args, **kwargs):
        raise AssertionError("a covariance formed outside K1")

    monkeypatch.setattr(port_ipsdta, "weighted_covariance_planes", counted)
    monkeypatch.setattr("audio_source_separation_tpu_torch.ops.covariance.weighted_covariance", forbidden)
    model = build(port, solver, n_blocks=n_blocks)
    for switch, value in switches.items():
        setattr(model, switch, value)
    np.random.seed(111)
    model(X, iteration=3)
    assert shapes == [(n_channels, n_bins, X.shape[-1])] * calls


def test_ldpsdtf_launches_no_kernel(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("LDPSDTF reached a kernel wrapper")

    for target in ("ops.cov_kernel.weighted_covariance_planes", "models.ipsdta.weighted_covariance_planes",
                   "ops.fused_ip.fused_auxiva_ip_iter"):  # fmt: skip
        monkeypatch.setattr("audio_source_separation_tpu_torch." + target, forbidden)
    rng = np.random.RandomState(7)
    for n_basis in (2, 3):
        A = rng.randn(n_basis, 6, 6)
        gram = np.einsum("kij,kt->ijt", A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(6), rng.rand(n_basis, 20) + 0.2)
        np.random.seed(111)
        model = port.LDPSDTF(n_basis=n_basis, device="cpu")
        model(gram, iteration=3)
        assert np.isfinite(model.loss).all()


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_finite_on_complex64(solver):
    """The CPU at complex64 (the card's precision): finite losses and
    output; Kondo's and TIPSDTA's loss falls."""
    X = mixture(n_bins=17, n_frames=64, dtype=np.complex64)
    np.random.seed(111)
    model = build(port, solver, n_blocks=8)
    Y = model(X, iteration=6)
    loss = np.asarray(model.loss)
    assert Y.dtype == torch.complex64 and torch.isfinite(Y).all() and np.isfinite(loss).all()
    if solver != "ikeshita":
        assert loss[-1] < loss[0]

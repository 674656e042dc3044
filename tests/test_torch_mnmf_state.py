"""The port's MNMF solvers' state against the JAX package on the CPU at
float64: the seed-111 init draws of each author, warm start, callbacks,
``save_state``/``load_state`` (Ozerov's factors in the input frame), a JAX
checkpoint resumed through ``state_from_jax``, the raises and warnings, and
where FastMNMF's diagonaliser covariances go (kernel K1's wrapper with
per-bin ``(C, F, T)`` weights, one call per iteration).  The loss
trajectories are in ``test_torch_mnmf.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import state_from_jax
from audio_source_separation_tpu_torch.models import mnmf as port_mnmf

from _torch_port import SawadaStates, assert_losses_match, jax_sawada_losses, to_np
from conftest import make_mixture

N_BASIS = 3
# solver id -> (class name, constructor kwargs, the fields a checkpoint holds)
SOLVERS = {
    "sawada": ("MultichannelISNMF", {"author": "Sawada"}, {"latent", "spatial", "basis", "activation"}),
    "ozerov": ("MultichannelISNMF", {"author": "Ozerov"}, {"mix_filter", "noise_covariance", "basis", "activation"}),
    "fast": ("FastMultichannelISNMF", {}, {"diagonalizer", "spatial_covariance", "basis", "activation"}),
}


def build(package, solver, **more):
    name, kwargs, _ = SOLVERS[solver]
    if package is port:
        more.setdefault("device", "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # Ozerov's "in progress"
        return getattr(package, name)(n_basis=N_BASIS, **kwargs, **more)


def mixture(n_channels=2, n_bins=9, n_frames=16):
    return make_mixture(np.random.RandomState(111), n_channels=n_channels, n_bins=n_bins, n_frames=n_frames)


def expected_losses(solver, ref, X, losses, states):
    """The JAX run's ``losses`` as the port defines them: Sawada's with the
    JAX package's rounding noise of the rank-1 ``x x^H`` taken out
    (``_torch_port.py::jax_sawada_losses``), the others as they are."""
    return jax_sawada_losses(ref, X, losses, states.states) if solver == "sawada" else losses


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_default_init_draws_what_jax_draws(solver):
    """``np.random.seed(111)`` gives both packages the same init (Ozerov's
    draws shaped by the mixture's power), and the next draw after the call
    is the same too."""
    X = mixture()
    ref, ours = build(jax_models, solver), build(port, solver)
    np.random.seed(111)
    ref(X, iteration=0)
    after_ref = np.random.rand()
    np.random.seed(111)
    ours(X, iteration=0)
    assert np.random.rand() == after_ref
    for field in SOLVERS[solver][2]:
        np.testing.assert_allclose(to_np(getattr(ours, field)), np.asarray(getattr(ref, field)), rtol=1e-13, atol=0)
    assert len(ours.loss) == len(ref.loss) == 1


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_warm_start_resumes_the_run(solver):
    """2 + 1 warm-started iterations equal 3 straight ones (Ozerov resumes
    from its published input-frame factors)."""
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


@pytest.mark.parametrize("solver,calls", [("sawada", 4), ("ozerov", 4), ("fast", 3)])
def test_callbacks_see_each_iteration(solver, calls):
    """Callbacks run after init and after every iteration for the MNMF
    solver, after iterations only for FastMNMF, and see the basis that
    JAX's do (Ozerov's in the input frame)."""
    X = mixture()
    seen, seen_ref, states = [], [], SawadaStates()
    np.random.seed(111)
    ours = build(port, solver, callbacks=lambda s: seen.append(to_np(s.basis).copy()))
    ours(X, iteration=3)

    def record(s):
        seen_ref.append(np.asarray(s.basis).copy())
        if solver == "sawada":
            states(s)

    np.random.seed(111)
    ref = build(jax_models, solver, callbacks=record)
    ref(X, iteration=3)
    assert len(seen) == len(seen_ref) == calls
    for a, b in zip(seen, seen_ref):
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert_losses_match(ours.loss, expected_losses(solver, ref, X, ref.loss, states))


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_save_state_round_trip(tmp_path, solver):
    """``save_state`` writes the checkpoint that JAX's writes after the same
    run (Ozerov's basis and noise in the input frame, not the working
    state's equilibrated one), and ``load_state`` resumes onto the straight
    run."""
    X = mixture()
    np.random.seed(111)
    first = build(port, solver)
    first(X, iteration=2)
    first.save_state(tmp_path / "port.npz")
    loaded = first.load_state(tmp_path / "port.npz")
    np.random.seed(111)
    ref = build(jax_models, solver)
    ref(X, iteration=2)
    ref.save_state(tmp_path / "jax.npz")
    expected = jax_models.MultichannelISNMF.load_state(tmp_path / "jax.npz")
    assert set(loaded) == set(expected) == SOLVERS[solver][2]
    for field, value in expected.items():
        np.testing.assert_allclose(loaded[field], value, atol=1e-8)
    resumed = build(port, solver)
    Y = resumed(X, iteration=1, **loaded)
    np.random.seed(111)
    Y_straight = build(port, solver)(X, iteration=3)
    np.testing.assert_allclose(to_np(Y), to_np(Y_straight), atol=1e-10)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_resume_jax_checkpoint(tmp_path, solver):
    """A JAX checkpoint of each solver resumes in the port onto JAX's own
    resumed run."""
    X = mixture()
    np.random.seed(111)
    jax_solver = build(jax_models, solver)
    jax_solver(X, iteration=3)
    path = tmp_path / "mnmf.npz"
    jax_solver.save_state(path)
    states = SawadaStates()
    jax_solver.callbacks = [states] if solver == "sawada" else None
    Y_ref = jax_solver(X, iteration=3, **jax_models.MultichannelISNMF.load_state(path))

    loaded = state_from_jax(path, device="cpu")
    assert set(loaded) == SOLVERS[solver][2] and all(isinstance(v, torch.Tensor) for v in loaded.values())
    ours = build(port, solver)
    Y = ours(X, iteration=3, **loaded)
    assert_losses_match(ours.loss, expected_losses(solver, jax_solver, X, jax_solver.loss[4:], states))
    np.testing.assert_allclose(to_np(Y), np.asarray(Y_ref), atol=1e-8)
    np.testing.assert_allclose(to_np(ours.basis), np.asarray(jax_solver.basis), atol=1e-8)


@pytest.mark.parametrize(
    "name,kwargs,error",
    [
        ("MultichannelISNMF", {"author": "Sawada", "annealing": True}, ValueError),
        ("MultichannelISNMF", {"author": "Ozerov", "latent_size": 2}, ValueError),
        ("MultichannelISNMF", {"author": "Duong"}, AssertionError),
        ("FastMultichannelISNMF", {"partitioning": True}, ValueError),
    ],
    ids=["sawada-annealing", "ozerov-unknown", "unknown-author", "fast-partitioning"],
)
def test_constructors_raise_as_in_jax(name, kwargs, error):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with pytest.raises(error):
            getattr(jax_models, name)(**kwargs)
        with pytest.raises(error):
            getattr(port, name)(device="cpu", **kwargs)


def test_fast_mnmf_unknown_normalization_raises_at_the_update():
    X = mixture()
    for package, more in ((jax_models, {}), (port, {"device": "cpu"})):
        np.random.seed(111)
        with pytest.raises(ValueError, match="Choose 'power'"):
            package.FastMultichannelISNMF(n_basis=2, normalize="x", **more)(X, iteration=1)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_in_progress_warnings(package):
    """Ozerov and ``MultichanneltNMF`` warn; the stub's ``nll`` raises."""
    lib, more = (jax_models, {}) if package == "jax" else (port, {"device": "cpu"})
    with pytest.warns(UserWarning, match="in progress"):
        lib.MultichannelISNMF(author="Ozerov", **more)
    with pytest.warns(UserWarning, match="in progress"):
        stub = lib.MultichanneltNMF(n_basis=2, **more)
    with pytest.raises(NotImplementedError):
        stub.nll({})


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, each solver raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: port.MultichannelISNMF(),
        lambda: port.FastMultichannelISNMF(),
        lambda: port.MultichannelISNMF(author="Ozerov"),
        lambda: port.MultichanneltNMF(),
    ):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


@pytest.mark.parametrize(
    "solver,kwargs,n_channels,calls",
    [
        ("fast", {}, 2, 4),
        ("fast", {"guard": "none"}, 2, 4),
        ("fast", {"guard": "svd"}, 2, 4),
        ("fast", {}, 3, 4),
        ("fast", {}, 5, 4),
        ("sawada", {}, 2, 0),
        ("ozerov", {}, 2, 0),
    ],
    ids=["fast-one_norm", "fast-none", "fast-svd", "fast-C3", "fast-C5", "sawada", "ozerov"],
)
def test_covariance_goes_through_k1_per_bin(monkeypatch, solver, kwargs, n_channels, calls):
    """FastMNMF's diagonaliser takes exactly one call of K1's wrapper per
    iteration on every guard, with per-bin ``(C, F, T)`` weights,
    contiguous and of the mixture's real type as the CUDA kernel takes
    them, and nothing else forms a covariance; Sawada and Ozerov reach no
    kernel."""
    X = mixture(n_channels=n_channels)
    shapes = []
    wrapper = port_mnmf.weighted_covariance_planes

    def counted(X, weights):
        assert weights.is_contiguous() and weights.dtype == X.real.dtype
        shapes.append(tuple(weights.shape))
        return wrapper(X, weights)

    def forbidden(*args, **kwargs):
        raise AssertionError("a covariance formed outside K1")

    monkeypatch.setattr(port_mnmf, "weighted_covariance_planes", counted)
    monkeypatch.setattr("audio_source_separation_tpu_torch.ops.covariance.weighted_covariance", forbidden)
    np.random.seed(111)
    build(port, solver, **kwargs)(X, iteration=4)
    assert shapes == [(n_channels,) + X.shape[1:]] * calls


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_finite_and_falling_on_complex64(solver):
    """The CPU at complex64 (the card's precision): the loss stays finite
    and falls over the run, through the float32 guards."""
    X = make_mixture(np.random.RandomState(3), n_channels=2, n_bins=17, n_frames=64, dtype=np.complex64)
    np.random.seed(111)
    model = build(port, solver)
    Y = model(X, iteration=10)
    loss = np.asarray(model.loss)
    assert Y.dtype == torch.complex64 and torch.isfinite(Y).all() and np.isfinite(loss).all()
    assert loss[-1] < loss[0]

"""The port's ILRMA solvers' state against the JAX package on the CPU at
float64: the seed-111 init draws, warm start, callbacks, a JAX checkpoint
resumed through ``state_from_jax``, the raises, and where the spatial
covariance goes (kernel K1's wrapper with per-bin weights, one call per
update).  The loss trajectories are in ``test_torch_ilrma.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import state_from_jax
from audio_source_separation_tpu_torch.models import ilrma as port_ilrma
from audio_source_separation_tpu_torch.ops import cov_kernel

from conftest import make_mixture


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("partitioning", [False, True])
def test_default_init_draws_what_jax_draws(rng, partitioning):
    """``np.random.seed(111)`` gives both packages the same source model."""
    X = make_mixture(rng, n_channels=3, n_bins=11, n_frames=20)
    np.random.seed(111)
    ref = jax_models.GaussILRMA(n_basis=4, partitioning=partitioning)
    ref(X, iteration=0)
    np.random.seed(111)
    ours = port.GaussILRMA(n_basis=4, partitioning=partitioning, device="cpu")
    ours(X, iteration=0)
    fields = ("basis", "activation") + (("latent",) if partitioning else ())
    for field in fields:
        np.testing.assert_array_equal(_np(getattr(ours, field)), np.asarray(getattr(ref, field)))
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-12)


def test_warm_start_resumes_the_run(rng):
    """2 + 1 warm-started iterations equal 3 straight ones, and JAX's."""
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=24)
    np.random.seed(111)
    first = port.GaussILRMA(n_basis=3, recordable_loss=False, device="cpu")
    first(X, iteration=2)
    resumed = port.GaussILRMA(n_basis=3, recordable_loss=False, device="cpu")
    resumed(X, iteration=1, demix_filter=first.demix_filter, basis=first.basis, activation=first.activation)
    np.random.seed(111)
    straight = port.GaussILRMA(n_basis=3, recordable_loss=False, device="cpu")
    straight(X, iteration=3)
    np.random.seed(111)
    ref = jax_models.GaussILRMA(n_basis=3, recordable_loss=False)
    ref(X, iteration=3)
    np.testing.assert_allclose(_np(resumed.demix_filter), _np(straight.demix_filter), atol=1e-10)
    np.testing.assert_allclose(_np(straight.demix_filter), np.asarray(ref.demix_filter), atol=1e-8)


@pytest.mark.filterwarnings("ignore:in progress")
@pytest.mark.parametrize("algorithm", ["IP", "ISS"])
def test_callbacks_see_each_iteration(rng, algorithm):
    """Callbacks run after init and after every iteration, and see the
    basis, the complex estimates and (ISS: fitted) filter that JAX's do."""
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=24)
    seen, seen_ref = [], []

    def grab(into):
        return lambda s: into.append([_np(s.basis).copy(), _np(s.estimation).copy(), _np(s.demix_filter).copy()])

    np.random.seed(111)
    ours = port.GaussILRMA(n_basis=3, algorithm_spatial=algorithm, callbacks=grab(seen), device="cpu")
    ours(X, iteration=3)
    np.random.seed(111)
    ref = jax_models.GaussILRMA(n_basis=3, algorithm_spatial=algorithm, callbacks=grab(seen_ref))
    ref(X, iteration=3)
    assert len(seen) == len(seen_ref) == 4
    for ours_fields, ref_fields in zip(seen, seen_ref):
        for a, b in zip(ours_fields, ref_fields):
            np.testing.assert_allclose(a, b, atol=1e-9)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)


@pytest.mark.parametrize("kwargs", [{}, {"partitioning": True}], ids=["ip", "partitioning"])
def test_resume_jax_checkpoint(rng, tmp_path, kwargs):
    """A JAX ILRMA checkpoint (filter, estimates, basis, activation and,
    with partitioning, latent) resumes in the port onto JAX's own resumed
    run."""
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=24)
    np.random.seed(111)
    jax_solver = jax_models.GaussILRMA(n_basis=3, **kwargs)
    jax_solver(X, iteration=3)
    path = tmp_path / "ilrma.npz"
    jax_solver.save_state(path)
    jax_solver(X, iteration=3, **jax_models.GaussILRMA.load_state(path))

    loaded = state_from_jax(path, device="cpu")
    expected = {"demix_filter", "estimation", "basis", "activation"} | ({"latent"} if kwargs else set())
    assert set(loaded) == expected and all(isinstance(v, torch.Tensor) for v in loaded.values())
    ours = port.GaussILRMA(n_basis=3, device="cpu", **kwargs)
    Y = ours(X, iteration=3, **loaded)
    np.testing.assert_allclose(ours.loss, jax_solver.loss[4:], rtol=1e-9)
    np.testing.assert_allclose(_np(Y), np.asarray(jax_solver.estimation), atol=1e-8)
    np.testing.assert_allclose(_np(ours.basis), np.asarray(jax_solver.basis), atol=1e-8)


def test_iss_warns_in_progress():
    for package in (jax_models, port):
        with pytest.warns(UserWarning, match="in progress"):
            package.GaussILRMA(algorithm_spatial="ISS", **({"device": "cpu"} if package is port else {}))


@pytest.mark.parametrize("name", ["GGDILRMA", "KLILRMA", "RegularizedILRMA"])
def test_stubs_raise(name):
    with pytest.raises(NotImplementedError):
        getattr(jax_models, name)(n_basis=2)
    with pytest.raises(NotImplementedError):
        getattr(port, name)(n_basis=2, device="cpu")


@pytest.mark.parametrize(
    "name,kwargs,error",
    [
        ("GaussILRMA", {"partitioning": True, "domain": 1.5}, AssertionError),
        ("GaussILRMA", {"partitioning": True, "algorithm_spatial": "IP2"}, NotImplementedError),
        ("GaussILRMA", {"partitioning": True, "normalize": "projection-back"}, NotImplementedError),
        ("GaussILRMA", {"normalize": "rms"}, ValueError),
        ("TILRMA", {"partitioning": True}, NotImplementedError),
        ("TILRMA", {"normalize": "projection-back"}, ValueError),
        ("ConsistentGaussILRMA", {"partitioning": True, "fft_size": 16}, NotImplementedError),
    ],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_unsupported_configurations_raise_as_in_jax(rng, name, kwargs, error):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=16)
    np.random.seed(111)
    with pytest.raises(error):
        getattr(jax_models, name)(n_basis=2, **kwargs)(X, iteration=1)
    np.random.seed(111)
    with pytest.raises(error):
        getattr(port, name)(n_basis=2, device="cpu", **kwargs)(X, iteration=1)


@pytest.mark.parametrize(
    "make",
    [
        lambda: port.GaussILRMA(domain=1.5, device="cpu"),
        lambda: port.GaussILRMA(algorithm_spatial="ISS", device="cpu"),
        lambda: port.GaussILRMA(normalize="projection-back", device="cpu"),
        lambda: port.ConsistentGaussILRMA(fft_size=16, device="cpu"),
        lambda: port.GaussILRMA(partitioning=True, device="cpu"),
        lambda: port.TILRMA(device="cpu"),
    ],
    ids=["gauss-ip", "gauss-iss", "projection-back", "consistent", "partitioning", "t"],
)
def test_state_form(rng, make):
    """The power form carries ``estimation_power`` and the planes and no
    complex estimates; ISS and projection-back carry the estimates."""
    X = torch.as_tensor(make_mixture(rng, n_channels=2, n_bins=9, n_frames=16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solver = make()
    np.random.seed(0)
    kwargs = solver.prepare_state_kwargs(X, {})
    state = solver.init_state(X, **kwargs)
    state = solver.update_state(state)
    power = not solver._is_iss and solver.normalize in (False, True, "power")
    assert ("estimation_power" in state) == ("pair_products" in state) == ("estimation" not in state) == power
    assert ("demix_filter" in state) != solver._is_iss


@pytest.mark.filterwarnings("ignore:in progress")
@pytest.mark.parametrize(
    "name,kwargs,calls,rows",
    [
        ("GaussILRMA", {}, 4, 3),
        ("GaussILRMA", {"guard": "svd"}, 4, 3),
        ("GaussILRMA", {"algorithm_spatial": "IP2"}, 4, 2),
        ("GaussILRMA", {"normalize": "projection-back"}, 4, 3),
        ("TILRMA", {"nu": 1}, 4, 3),
        ("ConsistentGaussILRMA", {"fft_size": 16}, 4, 3),
        ("GaussILRMA", {"partitioning": True}, 4, 3),
        ("GaussILRMA", {"domain": 1.5}, 4, 3),
        ("GaussILRMA", {"algorithm_spatial": "ISS"}, 0, None),
    ],
    ids=["ip", "ip-svd", "ip2", "projection-back", "t", "consistent", "partitioning", "domain", "iss"],
)
def test_covariance_goes_through_k1_per_bin(rng, monkeypatch, name, kwargs, calls, rows):
    """Every covariance of an ILRMA update is one call of K1's wrapper with
    per-bin ``(rows, F, T)`` weights (IP2's pair in one call), contiguous
    and of the mixture's real type as the CUDA kernel takes them, and
    nothing else forms a covariance: the direct contraction is never
    reached."""
    X = make_mixture(rng, n_channels=3, n_bins=9, n_frames=16)
    shapes = []
    wrapper = cov_kernel.weighted_covariance_planes

    def counted(X, weights):
        assert weights.is_contiguous() and weights.dtype == X.real.dtype
        shapes.append(tuple(weights.shape))
        return wrapper(X, weights)

    def forbidden(*args, **kwargs):
        raise AssertionError("ILRMA formed a covariance outside K1")

    monkeypatch.setattr(port_ilrma, "weighted_covariance_planes", counted)
    monkeypatch.setattr("audio_source_separation_tpu_torch.models.iva.weighted_covariance_planes", counted)
    monkeypatch.setattr("audio_source_separation_tpu_torch.ops.covariance.weighted_covariance", forbidden)
    np.random.seed(111)
    getattr(port, name)(n_basis=2, device="cpu", **kwargs)(X, iteration=calls or 4)
    assert len(shapes) == calls
    assert all(shape == (rows, 9, 16) for shape in shapes)

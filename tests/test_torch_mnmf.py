"""The port's MNMF family against the JAX package on the CPU at float64.

Each case runs both packages on the same seeded mixture from the same
``np.random.seed(111)`` init draws and compares the loss trajectory (rtol
1e-9), the final state (``spatial``, ``mix_filter``, ``diagonalizer`` and
the factors) and the output (atol 1e-8).  Each JAX run is shared by the
three tests of its case through a module-scoped cache: JAX's compile is most
of their time.

Sawada's loss holds the log-determinant of the PSD-projected observed
covariance ``x x^H``, which is rank 1.  The port takes its eigenvalues as
``|x|^2`` and zeros, exactly; the JAX package takes them from its closed
form, whose zeros are rounding noise (about 1e-16 of the trace at C = 2,
1e-8 at C = 3), far above the ``eps tr`` ridge at C = 3.  So a Sawada case
holds the port's losses against the JAX package's with that noise's two
terms taken out (``_torch_port.py::jax_sawada_losses``, from the states
the JAX run's callbacks saw).  Init, warm start, callbacks, checkpoints,
the raises and the K1 route are in ``test_torch_mnmf_state.py``.
"""

import warnings

import numpy as np
import pytest

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port

from _torch_port import SawadaStates, assert_losses_match, jax_sawada_losses, to_np
from conftest import make_mixture

ITERATIONS, N_BINS, N_FRAMES, N_BASIS = 6, 17, 24, 3

SAWADA = {"author": "Sawada"}
OZEROV = {"author": "Ozerov"}
# name, constructor kwargs, C and class switches set on the instance
CASES = [
    ("MultichannelISNMF", SAWADA, 2, {}),
    ("MultichannelISNMF", SAWADA, 2, {"riccati_planes": False}),
    ("MultichannelISNMF", dict(SAWADA, normalize=False), 2, {}),
    ("MultichannelISNMF", SAWADA, 3, {}),  # the matrix Riccati path
    ("MultichannelISNMF", OZEROV, 2, {}),
    ("MultichannelISNMF", OZEROV, 3, {}),
    ("MultichannelISNMF", dict(OZEROV, annealing=True, annealing_iterations=4), 2, {}),
    ("MultichannelISNMF", dict(OZEROV, annealing=True, annealing_iterations=4), 3, {}),
    ("MultichannelISNMF", dict(OZEROV, normalize=False), 2, {}),
    ("FastMultichannelISNMF", {}, 2, {}),
    ("FastMultichannelISNMF", {}, 3, {}),
    ("FastMultichannelISNMF", {"guard": "none"}, 2, {}),
    ("FastMultichannelISNMF", {"guard": "svd"}, 2, {}),  # the matrix sweep
    ("FastMultichannelISNMF", {}, 5, {}),  # the matrix path
]
FIELDS = {
    "sawada": ("latent", "spatial", "basis", "activation"),
    "ozerov": ("mix_filter", "noise_covariance", "basis", "activation"),
    "fast": ("diagonalizer", "spatial_covariance", "basis", "activation"),
}


def _case_id(case):
    name, kwargs, n_channels, switches = case
    parts = [name] + ["{}={}".format(k, v) for k, v in {**kwargs, **switches}.items()] + ["C{}".format(n_channels)]
    return "-".join(parts)


def _kind(name, kwargs):
    return "fast" if name == "FastMultichannelISNMF" else kwargs["author"].lower()


def mixture(n_channels):
    return make_mixture(np.random.RandomState(111), n_channels=n_channels, n_bins=N_BINS, n_frames=N_FRAMES)


def run(package, name, kwargs, n_channels, switches, **more):
    """``package``'s solver on the case's mixture from the seed-111 draws:
    the solver and its output."""
    X = mixture(n_channels)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # Ozerov's "in progress"
        solver = getattr(package, name)(n_basis=N_BASIS, **kwargs, **more)
    for key, value in switches.items():
        setattr(solver, key, value)
    np.random.seed(111)
    return solver, solver(X, iteration=ITERATIONS)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of a case, each made once per module, and the
    states of the JAX run's losses (Sawada's, else ``None``)."""
    cache = {}

    def get(case):
        key = _case_id(case)
        if key not in cache:
            name, kwargs, n_channels, switches = case
            states = SawadaStates() if _kind(name, kwargs) == "sawada" else None
            cache[key] = (
                run(jax_models, name, kwargs, n_channels, switches, callbacks=states),
                run(port, name, kwargs, n_channels, switches, device="cpu"),
                states,
            )
        return cache[key]

    return get


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_loss_trajectory(runs, case):
    (ref, _), (ours, _), states = runs(case)
    assert len(ours.loss) == len(ref.loss) == ITERATIONS + 1
    expected = ref.loss
    if states is not None:
        expected = jax_sawada_losses(ref, mixture(case[2]), ref.loss, states.states)
    assert_losses_match(ours.loss, expected, rtol=1e-9)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_final_state(runs, case):
    (ref, _), (ours, _), _ = runs(case)
    for field in FIELDS[_kind(case[0], case[1])]:
        np.testing.assert_allclose(to_np(getattr(ours, field)), np.asarray(getattr(ref, field)), atol=1e-8)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_output(runs, case):
    (_, Y_ref), (_, Y), _ = runs(case)
    assert Y.device.type == "cpu" and tuple(Y.shape) == np.asarray(Y_ref).shape
    np.testing.assert_allclose(to_np(Y), np.asarray(Y_ref), atol=1e-8)

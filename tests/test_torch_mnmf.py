"""The port's MNMF family against the JAX package on the CPU at float64.

Each case runs both packages on the same seeded mixture from the same
``np.random.seed(111)`` init draws and compares the loss trajectory (rtol
1e-9), the final state (``spatial``, ``mix_filter``, ``diagonalizer`` and
the factors) and the output (atol 1e-8).  Each JAX run is shared by the
three tests of its case through a module-scoped cache: JAX's compile is most
of their time.

Sawada's loss holds the log-determinant of the PSD-projected observed
covariance ``x x^H``, which is rank 1: its small eigenvalues are the closed
form's rounding noise in both packages (about 1e-16 of the trace at C = 2,
1e-8 at C = 3, where the trigonometric eigvalsh loses half the digits), a
constant of the data that no update touches.  So a Sawada case holds the
loss increments ``L_k - L_0`` at 1e-9 of ``|L_0|`` and ``L_0`` at the last
entry of its case row.  Init, warm start, callbacks, checkpoints, the raises
and the K1 route are in ``test_torch_mnmf_state.py``.
"""

import warnings

import numpy as np
import pytest

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port

from _torch_port import assert_losses_match, to_np
from conftest import make_mixture

ITERATIONS, N_BINS, N_FRAMES, N_BASIS = 6, 17, 24, 3

SAWADA = {"author": "Sawada"}
OZEROV = {"author": "Ozerov"}
# name, constructor kwargs, C, class switches set on the instance, and the
# relative tolerance of the absolute loss (None: the whole trajectory at 1e-9)
CASES = [
    ("MultichannelISNMF", SAWADA, 2, {}, 5e-8),
    ("MultichannelISNMF", SAWADA, 2, {"riccati_planes": False}, 5e-8),
    ("MultichannelISNMF", dict(SAWADA, normalize=False), 2, {}, 5e-8),
    ("MultichannelISNMF", SAWADA, 3, {}, 5e-3),  # the matrix Riccati path
    ("MultichannelISNMF", OZEROV, 2, {}, None),
    ("MultichannelISNMF", OZEROV, 3, {}, None),
    ("MultichannelISNMF", dict(OZEROV, annealing=True, annealing_iterations=4), 2, {}, None),
    ("MultichannelISNMF", dict(OZEROV, annealing=True, annealing_iterations=4), 3, {}, None),
    ("MultichannelISNMF", dict(OZEROV, normalize=False), 2, {}, None),
    ("FastMultichannelISNMF", {}, 2, {}, None),
    ("FastMultichannelISNMF", {}, 3, {}, None),
    ("FastMultichannelISNMF", {"guard": "none"}, 2, {}, None),
    ("FastMultichannelISNMF", {"guard": "svd"}, 2, {}, None),  # the matrix sweep
    ("FastMultichannelISNMF", {}, 5, {}, None),  # the matrix path
]
FIELDS = {
    "sawada": ("latent", "spatial", "basis", "activation"),
    "ozerov": ("mix_filter", "noise_covariance", "basis", "activation"),
    "fast": ("diagonalizer", "spatial_covariance", "basis", "activation"),
}


def _case_id(case):
    name, kwargs, n_channels, switches, _ = case
    parts = [name] + ["{}={}".format(k, v) for k, v in {**kwargs, **switches}.items()] + ["C{}".format(n_channels)]
    return "-".join(parts)


def _kind(name, kwargs):
    return "fast" if name == "FastMultichannelISNMF" else kwargs["author"].lower()


def run(package, name, kwargs, n_channels, switches, **more):
    """``package``'s solver on the case's mixture from the seed-111 draws:
    the solver and its output."""
    X = make_mixture(np.random.RandomState(111), n_channels=n_channels, n_bins=N_BINS, n_frames=N_FRAMES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # Ozerov's "in progress"
        solver = getattr(package, name)(n_basis=N_BASIS, **kwargs, **more)
    for key, value in switches.items():
        setattr(solver, key, value)
    np.random.seed(111)
    return solver, solver(X, iteration=ITERATIONS)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of a case, each made once per module."""
    cache = {}

    def get(case):
        key = _case_id(case)
        if key not in cache:
            name, kwargs, n_channels, switches, _ = case
            cache[key] = (
                run(jax_models, name, kwargs, n_channels, switches),
                run(port, name, kwargs, n_channels, switches, device="cpu"),
            )
        return cache[key]

    return get


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_loss_trajectory(runs, case):
    (ref, _), (ours, _) = runs(case)
    assert len(ours.loss) == len(ref.loss) == ITERATIONS + 1
    assert_losses_match(ours.loss, ref.loss, rtol=1e-9, first_rtol=case[-1])


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_final_state(runs, case):
    (ref, _), (ours, _) = runs(case)
    for field in FIELDS[_kind(case[0], case[1])]:
        np.testing.assert_allclose(to_np(getattr(ours, field)), np.asarray(getattr(ref, field)), atol=1e-8)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_output(runs, case):
    (_, Y_ref), (_, Y) = runs(case)
    assert Y.device.type == "cpu" and tuple(Y.shape) == np.asarray(Y_ref).shape
    np.testing.assert_allclose(to_np(Y), np.asarray(Y_ref), atol=1e-8)

"""The port's IPSDTA solvers against the JAX package on the CPU at float64.

Each case runs both packages on the same seeded mixture from the same
``np.random.seed(111)`` init draws, 3 iterations of ``n_basis = 2``, and
compares the loss trajectory (rtol 1e-9), the final ``demix_filter``,
``basis``, ``activation`` and Ikeshita's ``fixed_point``, and the output
(rtol 1e-9, atol 1e-12 of the largest entry).  The cases cover each route:
the compact source steps at B = 2 (12 bins in 6 blocks) and at a padded
B = 3 (10 bins in 4 blocks of 2, 2, 3 and 3), the matrix steps at B = 4 (13
bins in 4 blocks), the planes VCD at C = 3 and the matrix VCD at C = 4, and
the off-default switches at B <= 3, each against the JAX package's same
route: the complex planes source steps (``source_compact=False``, with the
VCD's and the fixed point's complex inverses) and the K = 2 pencil streams
(``source_pencil=True``).
Each JAX run is shared by its case's three tests through a module-scoped
cache.  Init, warm start, callbacks, checkpoints, the raises and the K1
route are in ``test_torch_ipsdta_state.py``.
"""

import numpy as np
import pytest

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port

from _torch_port import to_np
from conftest import make_mixture

ITERATIONS, N_FRAMES, N_BASIS = 3, 24, 2
KONDO, IKESHITA, T3 = ("GaussIPSDTA", {"author": "Kondo"}), ("GaussIPSDTA", {"author": "Ikeshita"}), ("TIPSDTA", {"nu": 3.0})
PLANES, PENCIL = {"source_compact": False}, {"source_pencil": True}
# (class name, kwargs), C, n_bins, n_blocks[, the route switches]
CASES = [
    (KONDO, 2, 12, 6),
    (IKESHITA, 2, 12, 6),
    (T3, 2, 12, 6),
    (KONDO, 2, 10, 4),
    (IKESHITA, 2, 10, 4),
    (T3, 2, 10, 4),
    (KONDO, 2, 13, 4),
    (IKESHITA, 2, 13, 4),
    (T3, 2, 13, 4),
    (KONDO, 3, 12, 4),
    (KONDO, 4, 12, 6),
    (KONDO, 2, 12, 6, PLANES),
    (KONDO, 3, 10, 4, PLANES),
    (IKESHITA, 2, 10, 4, PLANES),
    (T3, 2, 10, 4, PLANES),
    (KONDO, 2, 12, 6, PENCIL),
    (KONDO, 2, 10, 4, dict(PENCIL, **PLANES)),
    (T3, 2, 10, 4, PENCIL),
]
FIELDS = ("demix_filter", "basis", "activation", "fixed_point")


def _case_id(case):
    (name, kwargs), n_channels, n_bins, n_blocks = case[:4]
    parts = [name] + ["{}={}".format(k, v) for k, v in {**kwargs, **(case[4] if len(case) > 4 else {})}.items()]
    return "-".join(parts + ["C{}".format(n_channels), "F{}".format(n_bins), "nb{}".format(n_blocks)])


def run(package, case, **more):
    """``package``'s solver on the case's mixture from the seed-111 draws:
    the solver and its output."""
    (name, kwargs), n_channels, n_bins, n_blocks = case[:4]
    X = make_mixture(np.random.RandomState(111), n_channels=n_channels, n_bins=n_bins, n_frames=N_FRAMES)
    solver = getattr(package, name)(n_basis=N_BASIS, n_blocks=n_blocks, **kwargs, **more)
    for switch, value in (case[4] if len(case) > 4 else {}).items():
        setattr(solver, switch, value)
    np.random.seed(111)
    return solver, solver(X, iteration=ITERATIONS)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of a case, each made once per module."""
    cache = {}

    def get(case):
        key = _case_id(case)
        if key not in cache:
            cache[key] = (run(jax_models, case), run(port, case, device="cpu"))
        return cache[key]

    return get


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(ours), ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_loss_trajectory(runs, case):
    (ref, _), (ours, _) = runs(case)
    assert len(ours.loss) == len(ref.loss) == ITERATIONS + 1
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_final_state(runs, case):
    (ref, _), (ours, _) = runs(case)
    for field in FIELDS:
        if getattr(ref, field, None) is None:
            assert getattr(ours, field, None) is None, field
            continue
        _close(getattr(ours, field), getattr(ref, field))


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_output(runs, case):
    (_, Y_ref), (_, Y) = runs(case)
    assert Y.device.type == "cpu" and tuple(Y.shape) == np.asarray(Y_ref).shape
    _close(Y, Y_ref)

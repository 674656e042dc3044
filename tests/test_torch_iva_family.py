"""The rest of the port's IVA family against the JAX package on the CPU at
float64: ISS (with and without ``iss_compat``), IP2/pairwise, the ``svd``
guard, C > 4, ``AuxGaussIVA``, the gradient solvers and the overdetermined
solver.  Each case compares the whole loss trajectory (rtol 1e-9), the final
demixing filter and the output (atol 1e-8), from the same seeded input;
then JAX checkpoints of ISS and IP2 resume in the port.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import state_from_jax

from conftest import make_mixture

ITERATIONS = 8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


CASES = [
    ("AuxLaplaceIVA", {"algorithm_spatial": "ISS"}, 2),
    ("AuxLaplaceIVA", {"algorithm_spatial": "ISS", "iss_compat": True}, 3),
    ("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}, 2),
    ("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}, 3),
    ("AuxLaplaceIVA", {"algorithm_spatial": "pairwise"}, 3),
    ("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}, 4),  # the matrix pair update
    ("AuxLaplaceIVA", {"algorithm_spatial": "IP2", "guard": "svd"}, 3),
    ("AuxLaplaceIVA", {"guard": "svd"}, 2),
    ("AuxLaplaceIVA", {}, 5),  # the matrix IP path
    ("AuxGaussIVA", {}, 2),  # K2's plain version, Gauss contrast
    ("AuxGaussIVA", {}, 3),
    ("AuxGaussIVA", {"algorithm_spatial": "ISS"}, 2),
    ("GradLaplaceIVA", {}, 2),
    ("GradLaplaceIVA", {}, 5),
    ("NaturalGradLaplaceIVA", {}, 3),
    ("NaturalGradLaplaceIVA", {}, 5),
]


def _case_id(case):
    name, kwargs, n_channels = case
    return "-".join([name] + ["{}={}".format(k, v) for k, v in kwargs.items()] + ["C{}".format(n_channels)])


@pytest.mark.parametrize("name,kwargs,n_channels", CASES, ids=[_case_id(c) for c in CASES])
def test_matches_jax_trajectory(rng, name, kwargs, n_channels):
    X = make_mixture(rng, n_channels=n_channels, n_bins=11, n_frames=40)
    ref = getattr(jax_models, name)(**kwargs)
    Y_ref = np.asarray(ref(X, iteration=ITERATIONS))
    ours = getattr(port, name)(device="cpu", **kwargs)
    Y = ours(X, iteration=ITERATIONS)
    assert len(ours.loss) == ITERATIONS + 1
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(_np(Y), Y_ref, atol=1e-8)
    if kwargs.get("algorithm_spatial") == "ISS":
        assert ours.demix_filter is None and ref.demix_filter is None  # no callbacks: no fit
    else:
        np.testing.assert_allclose(_np(ours.demix_filter), np.asarray(ref.demix_filter), atol=1e-8)


def test_iss_compat_changes_the_trajectory(rng):
    """``iss_compat`` selects the reference's self-steering scale: another
    trajectory, and the default one descends monotonically."""
    X = make_mixture(rng, n_channels=2, n_bins=11, n_frames=40)
    default = port.AuxLaplaceIVA(algorithm_spatial="ISS", device="cpu")
    default(X, iteration=ITERATIONS)
    compat = port.AuxLaplaceIVA(algorithm_spatial="ISS", iss_compat=True, device="cpu")
    compat(X, iteration=ITERATIONS)
    assert compat.iss_compat and not default.iss_compat
    assert not np.allclose(default.loss[1:], compat.loss[1:])
    assert np.all(np.diff(default.loss) <= 1e-9 * np.abs(default.loss[:-1]))


def test_iss_callbacks_see_the_least_squares_filter(rng):
    X = make_mixture(rng, n_channels=2, n_bins=9, n_frames=24)
    seen, seen_ref = [], []
    ours = port.AuxLaplaceIVA(
        algorithm_spatial="ISS", callbacks=lambda s: seen.append(_np(s.demix_filter).copy()), device="cpu"
    )
    ours(X, iteration=3)
    ref = jax_models.AuxLaplaceIVA(
        algorithm_spatial="ISS", callbacks=lambda s: seen_ref.append(np.asarray(s.demix_filter).copy())
    )
    ref(X, iteration=3)
    assert len(seen) == len(seen_ref) == 4
    for a, b in zip(seen, seen_ref):
        np.testing.assert_allclose(a, b, atol=1e-9)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)


def test_overdetermined_matches_jax(rng):
    """4 mics -> 2 sources: PCA, AuxIVA, projection-back onto the 4-channel
    mixture."""
    X = make_mixture(rng, n_channels=4, n_bins=11, n_frames=40)
    ref = jax_models.OverAuxLaplaceIVA("IP", n_sources=2)
    Y_ref = np.asarray(ref(X, iteration=ITERATIONS))
    ours = port.OverAuxLaplaceIVA("IP", n_sources=2, device="cpu")
    Y = ours(X, iteration=ITERATIONS)
    assert Y.shape == (2, 11, 40) and ours.apply_projection_back
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(_np(Y), Y_ref, atol=1e-8)
    np.testing.assert_allclose(_np(ours.estimation), Y_ref, atol=1e-8)


def test_overdetermined_to_one_source_matches_jax(rng):
    """3 mics -> 1 source: the reduced mixture has one channel (K1 at
    C = N = 1 on the card)."""
    X = make_mixture(rng, n_channels=3, n_bins=11, n_frames=40)
    ref = jax_models.OverAuxLaplaceIVA("IP", n_sources=1)
    Y_ref = np.asarray(ref(X, iteration=ITERATIONS))
    ours = port.OverAuxLaplaceIVA("IP", n_sources=1, device="cpu")
    Y = ours(X, iteration=ITERATIONS)
    assert Y.shape == (1, 11, 40)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(_np(Y), Y_ref, atol=1e-8)


def test_resume_jax_iss_checkpoint(rng, tmp_path):
    """A JAX ISS checkpoint holds only ``estimation``: the port resumes it
    onto JAX's own resumed run."""
    X = make_mixture(rng, n_channels=3, n_bins=9, n_frames=24)
    jax_solver = jax_models.AuxLaplaceIVA(algorithm_spatial="ISS")
    jax_solver(X, iteration=3)
    path = tmp_path / "iss.npz"
    jax_solver.save_state(path)
    jax_solver(X, iteration=3, **jax_models.AuxLaplaceIVA.load_state(path))

    kwargs = state_from_jax(path, device="cpu")
    assert sorted(kwargs) == ["estimation"]
    ours = port.AuxLaplaceIVA(algorithm_spatial="ISS", device="cpu")
    Y = ours(X, iteration=3, **kwargs)
    np.testing.assert_allclose(ours.loss, jax_solver.loss[4:], rtol=1e-9)
    np.testing.assert_allclose(_np(Y), np.asarray(jax_solver.estimation), atol=1e-8)


def test_resume_jax_ip2_state(rng, tmp_path):
    """A JAX IP2 checkpoint holds ``step_count``; the port resumes it at the
    right pair, onto JAX's uninterrupted 3 + 3 run.  (The JAX package's own
    ``load_state`` cannot resume it: its ``init_state`` takes no
    ``step_count``.)"""
    X = make_mixture(rng, n_channels=3, n_bins=9, n_frames=24)
    jax_solver = jax_models.AuxLaplaceIVA(algorithm_spatial="IP2")
    jax_solver(X, iteration=3)
    path = tmp_path / "ip2.npz"
    jax_solver.save_state(path)
    with pytest.raises(TypeError):
        jax_solver(X, iteration=1, **jax_models.AuxLaplaceIVA.load_state(path))
    straight = jax_models.AuxLaplaceIVA(algorithm_spatial="IP2")
    straight(X, iteration=6)

    kwargs = state_from_jax(path, device="cpu")
    assert kwargs["step_count"] == 3
    ours = port.AuxLaplaceIVA(algorithm_spatial="IP2", device="cpu")
    ours(X, iteration=3, **kwargs)
    np.testing.assert_allclose(ours.loss, straight.loss[3:], rtol=1e-9)
    np.testing.assert_allclose(_np(ours.demix_filter), np.asarray(straight.demix_filter), atol=1e-8)
    assert int(ours.step_count) == 6

    # the port's own checkpoint carries the counter too
    ours.save_state(tmp_path / "port.npz")
    again = port.AuxLaplaceIVA(algorithm_spatial="IP2", device="cpu")
    again(X, iteration=1, **port.AuxLaplaceIVA.load_state(tmp_path / "port.npz"))
    assert int(again.step_count) == 7


@pytest.mark.parametrize("name,algorithm", [("AuxLaplaceIVA", "ISS"), ("AuxLaplaceIVA", "IP2"), ("AuxGaussIVA", "IP")])
def test_monotone_on_complex64(rng, name, algorithm):
    """The CPU at complex64 (the card's precision): the loss stays finite
    and does not rise past float32 rounding."""
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=64, dtype=np.complex64)
    solver = getattr(port, name)(algorithm_spatial=algorithm, device="cpu")
    Y = solver(X, iteration=10)
    loss = np.asarray(solver.loss)
    assert Y.dtype == torch.complex64 and torch.isfinite(Y).all() and np.isfinite(loss).all()
    assert np.all(np.diff(loss) <= 1e-5 * np.abs(loss[:-1]))

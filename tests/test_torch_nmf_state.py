"""The port's factorisation models' state against the JAX package on the
CPU at float64: the seed-111 init draws, the loss length, warm start,
callbacks, ``save_state``/``load_state``, a JAX checkpoint resumed through
``state_from_jax``, the raises, and the solver loop's TF32 scope.  The loss
trajectories are in ``test_torch_nmf.py``.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import state_from_jax
from audio_source_separation_tpu_torch.runtime.solver import full_f32_matmuls

from _torch_port import N_BASIS, factors, make_target, to_np

KINDS = {
    "EUCNMF": "nmf",
    "ISNMF": "nmf",
    "CauchyNMF": "nmf",
    "ComplexEUCNMF": "complex",
    "CovarianceISNMF": "covariance",
    "EUCNTF": "ntf",
}
# the models whose warm-startable fields are their whole state (the
# ComplexEUCNMF checkpoint holds no phase)
RESUMABLE = ["EUCNMF", "CovarianceISNMF", "EUCNTF"]


def _pair(name, **kwargs):
    """The JAX model and its port, both ``n_basis=N_BASIS``."""
    return getattr(jax_models, name)(n_basis=N_BASIS, **kwargs), getattr(port, name)(
        n_basis=N_BASIS, device="cpu", **kwargs
    )


@pytest.mark.parametrize("name", sorted(KINDS))
def test_default_init_draws_what_jax_draws(rng, name):
    """``np.random.seed(111)`` gives both packages the same factors (and
    ComplexEUCNMF's discarded phase draw): the next draw after the call is
    the same too."""
    target = make_target(KINDS[name], rng)
    ref, ours = _pair(name)
    np.random.seed(111)
    ref(target, iteration=0)
    after_ref = np.random.rand()
    np.random.seed(111)
    ours(target, iteration=0)
    after = np.random.rand()
    assert after == after_ref
    assert ours.loss == ref.loss == []
    for field in ("basis", "activation", "partitioning", "phase_cos", "phase_sin", "spatial"):
        if hasattr(ref, field):
            np.testing.assert_allclose(to_np(getattr(ours, field)), np.asarray(getattr(ref, field)), rtol=1e-14)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_loss_has_one_entry_per_update(rng, name):
    """No entry before the first update, across calls too; the IVA family
    keeps its initial entry."""
    target = make_target(KINDS[name], rng)
    np.random.seed(111)
    model = getattr(port, name)(n_basis=N_BASIS, device="cpu")
    model(target, iteration=3)
    model(target, iteration=2)
    assert len(model.loss) == 5 and np.isfinite(model.loss).all()
    iva = port.AuxLaplaceIVA(device="cpu")
    iva(np.random.RandomState(0).randn(2, 5, 8) + 0j, iteration=3)
    assert len(iva.loss) == 4


@pytest.mark.parametrize("name", RESUMABLE)
def test_warm_start_resumes_the_run(rng, name):
    """5 + 5 warm-started iterations equal 10 straight ones, and JAX's: the
    published factors (CovarianceISNMF's basis in the input frame) are the
    warm-start kwargs."""
    target = make_target(KINDS[name], rng)
    init = factors(KINDS[name], target)
    ref, first = _pair(name)
    ref(target, iteration=10, **init)
    first(target, iteration=5, **init)
    fields = {k: getattr(first, k) for k in init}
    resumed = getattr(port, name)(n_basis=N_BASIS, device="cpu")
    out = resumed(target, iteration=5, **fields)
    np.testing.assert_allclose(first.loss + resumed.loss, ref.loss, rtol=1e-9)
    for field in init:
        np.testing.assert_allclose(to_np(getattr(resumed, field)), np.asarray(getattr(ref, field)), atol=1e-8)
    assert len(out) == len(init)


@pytest.mark.parametrize("name", ["EUCNMF", "CovarianceISNMF"])
def test_callbacks_see_each_iteration(rng, name):
    """A ``callbacks`` kwarg runs after init and after every update with the
    factors published (the input-frame basis), as in the JAX package."""
    target = make_target(KINDS[name], rng)
    init = factors(KINDS[name], target)
    seen, seen_ref = [], []

    def grab(into):
        return [lambda m: into.append((to_np(m.basis).copy(), to_np(m.activation).copy()))]

    ref, ours = _pair(name)
    ref(target, iteration=3, callbacks=grab(seen_ref), **init)
    ours(target, iteration=3, callbacks=grab(seen), **init)
    assert len(seen) == len(seen_ref) == 4 and len(ours.loss) == 3
    for got, want in zip(seen, seen_ref):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-9)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)


@pytest.mark.parametrize("name", RESUMABLE)
def test_save_state_round_trip(rng, tmp_path, name):
    """The port's checkpoint holds what JAX's holds (CovarianceISNMF's
    basis in the input frame), and resuming from it continues the run."""
    target = make_target(KINDS[name], rng)
    init = factors(KINDS[name], target)
    ref, ours = _pair(name)
    ref(target, iteration=4, **init)
    ours(target, iteration=4, **init)
    ref.save_state(tmp_path / "jax.npz")
    ours.save_state(tmp_path / "port.npz")
    saved, saved_ref = ours.load_state(tmp_path / "port.npz"), ref.load_state(tmp_path / "jax.npz")
    assert set(saved) == set(saved_ref) == set(init)
    for field in saved:
        np.testing.assert_allclose(saved[field], saved_ref[field], atol=1e-9)
    straight = getattr(port, name)(n_basis=N_BASIS, device="cpu")
    straight(target, iteration=7, **init)
    resumed = getattr(port, name)(n_basis=N_BASIS, device="cpu")
    resumed(target, iteration=3, **saved)
    np.testing.assert_allclose(resumed.loss, straight.loss[4:], rtol=1e-9)


@pytest.mark.parametrize("name", ["EUCNMF", "ComplexEUCNMF", "CovarianceISNMF", "EUCNTF"])
def test_resume_jax_checkpoint(rng, tmp_path, name):
    """A JAX checkpoint resumes in the port through ``state_from_jax`` onto
    JAX's own resumed run (ComplexEUCNMF's holds no phase: both re-derive
    it from the target, after the same discarded draw)."""
    target = make_target(KINDS[name], rng)
    np.random.seed(111)
    jax_model = getattr(jax_models, name)(n_basis=N_BASIS)
    jax_model(target, iteration=3)
    path = tmp_path / "state.npz"
    jax_model.save_state(path)
    jax_model(target, iteration=3, **jax_model.load_state(path))

    loaded = state_from_jax(path, device="cpu")
    assert set(loaded) == set(np.load(path).files) and all(isinstance(v, torch.Tensor) for v in loaded.values())
    ours = getattr(port, name)(n_basis=N_BASIS, device="cpu")
    ours(target, iteration=3, **loaded)
    np.testing.assert_allclose(ours.loss, jax_model.loss[3:], rtol=1e-9)
    np.testing.assert_allclose(to_np(ours.basis), np.asarray(jax_model.basis), atol=1e-8)


def test_state_from_jax_refuses_an_unknown_state():
    with pytest.raises(KeyError):
        state_from_jax({"weights": np.zeros(3)}, device="cpu")


@pytest.mark.parametrize(
    "name,kwargs,error",
    [
        ("EUCNMF", {"domain": 2.5}, AssertionError),
        ("EUCNMF", {"algorithm": "me"}, AssertionError),
        ("KLNMF", {"domain": 0.5}, AssertionError),
        ("ISNMF", {"domain": 1.5, "algorithm": "me"}, AssertionError),
        ("TNMF", {"domain": 1}, AssertionError),
        ("CauchyNMF", {"domain": 1}, AssertionError),
        ("CauchyNMF", {"algorithm": "multiplicative"}, ValueError),
    ],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_constructors_raise_as_in_jax(name, kwargs, error):
    with pytest.raises(error):
        getattr(jax_models, name)(**kwargs)
    with pytest.raises(error):
        getattr(port, name)(device="cpu", **kwargs)


def test_covariance_isnmf_four_channels_raises(rng):
    """C >= 4 is past the closed forms: ``ValueError`` in both packages."""
    target = make_target("covariance", rng, n_channels=4)
    for model in _pair("CovarianceISNMF"):
        np.random.seed(111)
        with pytest.raises(ValueError):
            model(target, iteration=1)


def _tf32():
    return torch.backends.cuda.matmul.fp32_precision


@pytest.mark.parametrize("api", ["legacy", "precision"])
def test_solver_loop_restores_the_callers_tf32(rng, api):
    """The loop runs with TF32 off and the caller's setting comes back after
    the call, and after a call that raises, whichever API set it."""
    before = torch.get_float32_matmul_precision()
    try:
        if api == "legacy":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        seen = []
        model = port.EUCNMF(n_basis=2, device="cpu")
        model(make_target("nmf", rng), iteration=2, callbacks=[lambda m: seen.append(_tf32())])
        assert seen == ["ieee"] * 3
        assert torch.backends.cuda.matmul.allow_tf32 and _tf32() == "tf32"

        def fail(m):
            assert _tf32() == "ieee"
            raise RuntimeError("stop")

        with pytest.raises(RuntimeError, match="stop"):
            model(make_target("nmf", rng), iteration=2, callbacks=[fail])
        assert torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def test_full_f32_matmuls_restores_the_newer_setting():
    """A caller who set only ``fp32_precision`` gets it back."""
    before = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        with full_f32_matmuls():
            assert _tf32() == "ieee" and not torch.backends.cuda.matmul.allow_tf32
        assert _tf32() == "tf32"
    finally:
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.set_float32_matmul_precision(before)

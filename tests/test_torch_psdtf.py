"""The port's LDPSDTF against the JAX package on the CPU at float64.

Each case factorises the same seeded Gram target (the recipe of the JAX
benchmark's LDPSDTF row, ``benchmarks/run_all.py:258-265``, at B = 8 taps
and 24 frames) from the same ``np.random.seed(111)`` draws, 6 iterations,
and compares the loss trajectory (rtol 1e-9), the published ``basis`` and
``activation`` (in the target's frame) and the returned factors (rtol
1e-9): the K = 2 pencil route and the K = 3 route that carries the model's
``eigh``, each with and without trace normalisation, and a complex Hermitian
target.  Then the raises, warm start and checkpoints (a JAX checkpoint
through ``state_from_jax``), the loop utility ``nonparallel_inv``, and
finite losses at float32.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
from audio_source_separation_tpu.models.psdtf import nonparallel_inv as jax_nonparallel_inv
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch import state_from_jax
from audio_source_separation_tpu_torch.models.psdtf import nonparallel_inv

from _torch_port import to_np

ITERATIONS, TAPS, N_FRAMES = 6, 8, 24


def gram(n_basis, taps=TAPS, n_frames=N_FRAMES, seed=7, complex_=False):
    """``(taps, taps, n_frames)`` from ``n_basis`` PSD Gram bases ``a a^H +
    0.5 I`` and positive activations, ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    bases = [rng.randn(taps, taps) + (1j * rng.randn(taps, taps) if complex_ else 0) for _ in range(n_basis)]
    stacked = np.stack([a @ a.conj().T + 0.5 * np.eye(taps) for a in bases])
    return np.einsum("kij,kt->ijt", stacked, np.abs(rng.randn(n_basis, n_frames)) + 0.2)


# n_basis, normalize, complex target
CASES = [(2, True, False), (3, True, False), (2, False, False), (3, False, False), (2, True, True), (3, True, True)]


def _case_id(case):
    n_basis, normalize, complex_ = case
    return "K{}-{}{}".format(n_basis, "normalize" if normalize else "raw", "-complex" if complex_ else "")


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of a case, each made once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            n_basis, normalize, complex_ = case
            target = gram(n_basis, complex_=complex_)
            out = []
            for package, more in ((jax_models, {}), (port, {"device": "cpu"})):
                model = package.LDPSDTF(n_basis=n_basis, normalize=normalize, **more)
                np.random.seed(111)
                out.append((model, model(target, iteration=ITERATIONS)))
            cache[case] = out
        return cache[case]

    return get


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(ours), ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_loss_trajectory(runs, case):
    (ref, _), (ours, _) = runs(case)
    assert len(ours.loss) == len(ref.loss) == ITERATIONS
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_factors(runs, case):
    """The returned ``(V, H)`` and the published ``basis``/``activation``
    (in the target's frame); a real target stays real."""
    (ref, (V_ref, H_ref)), (ours, (V, H)) = runs(case)
    _close(V, V_ref)
    _close(H, H_ref)
    _close(ours.basis, ref.basis)
    _close(ours.activation, ref.activation)
    assert V.is_complex() == case[2] and not H.is_complex()


@pytest.mark.parametrize("n_basis", [2, 3])
def test_carry_matches_jax(runs, n_basis):
    """The carried decomposition: the pencil ``(G, d, log det V_1)`` at
    K = 2 (up to each column's sign), the model's eigenvalues at K = 3."""
    (ref, _), (ours, _) = runs((n_basis, True, False))
    if n_basis == 2:
        _close(ours.pencil_d, ref.pencil_d)
        _close(ours.pencil_logdet, ref.pencil_logdet)
        G, G_ref = to_np(ours.pencil_G), np.asarray(ref.pencil_G)
        _close(np.abs(G), np.abs(G_ref))
    else:
        _close(ours.y_eigvals, ref.y_eigvals)
        _close(ours.frame_scale, ref.frame_scale)


@pytest.mark.parametrize("algorithm,error", [("em", NotImplementedError), ("sgd", ValueError)])
def test_algorithm_raises_as_in_jax(algorithm, error):
    with pytest.raises(error):
        jax_models.LDPSDTF(algorithm=algorithm)
    with pytest.raises(error):
        port.LDPSDTF(algorithm=algorithm, device="cpu")


@pytest.mark.parametrize("n_basis", [2, 3])
def test_warm_start_and_checkpoints(tmp_path, n_basis):
    """2 + 1 warm-started iterations equal 3 straight ones (the activation
    round-trips in the target's frame); the port's checkpoint holds JAX's
    fields and values; a JAX checkpoint resumes in the port onto JAX's own
    resumed run."""
    target = gram(n_basis)
    np.random.seed(111)
    first = port.LDPSDTF(n_basis=n_basis, device="cpu")
    first(target, iteration=2)
    first.save_state(tmp_path / "port.npz")
    loaded = first.load_state(tmp_path / "port.npz")
    V, H = port.LDPSDTF(n_basis=n_basis, device="cpu")(target, iteration=1, **loaded)
    np.random.seed(111)
    V_straight, H_straight = port.LDPSDTF(n_basis=n_basis, device="cpu")(target, iteration=3)
    _close(V, to_np(V_straight))
    _close(H, to_np(H_straight))

    np.random.seed(111)
    ref = jax_models.LDPSDTF(n_basis=n_basis)
    ref(target, iteration=2)
    ref.save_state(tmp_path / "jax.npz")
    expected = jax_models.LDPSDTF.load_state(tmp_path / "jax.npz")
    assert set(loaded) == set(expected) == {"basis", "activation"}
    for field, value in expected.items():
        _close(loaded[field], value)
    V_ref, H_ref = ref(target, iteration=2, **expected)
    ours = port.LDPSDTF(n_basis=n_basis, device="cpu")
    V, H = ours(target, iteration=2, **state_from_jax(tmp_path / "jax.npz", device="cpu"))
    np.testing.assert_allclose(ours.loss, ref.loss[2:], rtol=1e-9)
    _close(V, V_ref)
    _close(H, H_ref)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("use_cholesky", [True, False])
def test_nonparallel_inv(rng, use_cholesky, as_tensor):
    """NumPy input on ``device="cpu"``, and a CPU tensor, which stays on its
    device."""
    A = rng.randn(3, 2, 5, 5) + 1j * rng.randn(3, 2, 5, 5)
    X = A @ np.conj(np.swapaxes(A, -1, -2)) + np.eye(5)
    if as_tensor:
        ours = nonparallel_inv(torch.as_tensor(X), use_cholesky=use_cholesky)
    else:
        ours = nonparallel_inv(X, use_cholesky=use_cholesky, device="cpu")
    assert ours.device.type == "cpu" and ours.dtype == torch.complex128 and ours.shape == X.shape
    np.testing.assert_allclose(to_np(ours), jax_nonparallel_inv(X, use_cholesky=use_cholesky), rtol=1e-10, atol=1e-13)


def test_nonparallel_inv_numpy_input_defaults_to_cuda(rng, monkeypatch):
    """NumPy input goes to the card unless the caller asks for the CPU: on a
    machine without one, the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nonparallel_inv(np.eye(3)[None])


@pytest.mark.parametrize("n_basis", [2, 3])
def test_finite_and_falling_at_float32(n_basis):
    """The CPU at float32 (the card's precision): the losses stay finite and
    fall, through the float32 ridges and the per-frame equilibration."""
    target = gram(n_basis, n_frames=64).astype(np.float32)
    np.random.seed(111)
    model = port.LDPSDTF(n_basis=n_basis, device="cpu")
    V, H = model(target, iteration=10)
    loss = np.asarray(model.loss)
    assert V.dtype == H.dtype == torch.float32
    assert np.isfinite(loss).all() and torch.isfinite(V).all() and loss[-1] < loss[0]

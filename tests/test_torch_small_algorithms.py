"""The port's small algorithms against the JAX package on the CPU at
float64 (atol 1e-10): ``utils/linalg.py``, ``minimum_distortion_principle``,
``whitening`` (up to each row's sign), ``FixedPointICA`` and the
``algorithm/stft.py`` alias; then the ``models`` and top-level export lists
against the JAX package's."""

import importlib
import types

import numpy as np
import pytest
import torch

import audio_source_separation_tpu as jax_pkg
import audio_source_separation_tpu.models as jax_models
from audio_source_separation_tpu.algorithm.ica import FixedPointICA as JaxFixedPointICA
from audio_source_separation_tpu.utils import linalg as jax_linalg
import audio_source_separation_tpu_torch as port
import audio_source_separation_tpu_torch.models as port_models
from audio_source_separation_tpu_torch.algorithm import (
    generalized_minimum_distortion_principle,
    minimum_distortion_principle,
)
from audio_source_separation_tpu_torch.algorithm.ica import FixedPointICA
from audio_source_separation_tpu_torch.utils import linalg, eye_like_filter, parallel_sort, to_hermite, to_psd

from _torch_port import to_np
from conftest import make_mixture

def _matrices(rng, shape, n):
    return rng.randn(*shape, n, n) + 1j * rng.randn(*shape, n, n)


def test_to_hermite(rng):
    X = _matrices(rng, (4, 3), 3)
    np.testing.assert_allclose(to_np(to_hermite(torch.as_tensor(X))), np.asarray(jax_linalg.to_hermite(X)), atol=1e-10)
    X = rng.randn(3, 4, 3)  # other axes
    np.testing.assert_allclose(
        to_np(to_hermite(torch.as_tensor(X), axis1=0, axis2=2)),
        np.asarray(jax_linalg.to_hermite(X, axis1=0, axis2=2)),
        atol=1e-10,
    )


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_to_psd(rng, n):
    X = _matrices(rng, (5, 2), n)  # indefinite: the shift is taken
    out = to_np(to_psd(torch.as_tensor(X), eps=1e-6))
    np.testing.assert_allclose(out, np.asarray(jax_linalg.to_psd(X, eps=1e-6)), atol=1e-10)
    # the least eigenvalue is shifted up to 0 where negative, then ridged
    least = np.linalg.eigvalsh((X + np.swapaxes(X, -2, -1).conj()) / 2)[..., 0]
    trace = np.trace(X, axis1=-2, axis2=-1).real
    np.testing.assert_allclose(np.linalg.eigvalsh(out)[..., 0], np.maximum(least, 0) + 1e-6 * trace, atol=1e-10)


def test_parallel_sort(rng):
    x = rng.randn(4, 5, 3)
    order = np.stack([rng.permutation(5)[:4] for _ in range(4)])
    np.testing.assert_allclose(
        to_np(parallel_sort(torch.as_tensor(x), torch.as_tensor(order), axis=-2)),
        np.asarray(jax_linalg.parallel_sort(x, order, axis=-2)),
        atol=1e-10,
    )
    order = rng.randint(0, 3, size=(4, 5, 2))
    np.testing.assert_allclose(
        to_np(parallel_sort(torch.as_tensor(x), torch.as_tensor(order), axis=-1)),
        np.asarray(jax_linalg.parallel_sort(x, order, axis=-1)),
        atol=1e-10,
    )


def test_eye_like_filter_and_helpers(rng):
    W = eye_like_filter(6, 2, 3, dtype=torch.complex128, device="cpu")
    np.testing.assert_allclose(to_np(W), np.asarray(jax_linalg.eye_like_filter(6, 2, 3, dtype=np.complex128)))
    X = rng.randn(4, 3) + 1j * rng.randn(4, 3)
    U = _matrices(rng, (4,), 3)
    np.testing.assert_allclose(
        to_np(linalg.hermitian_outer(torch.as_tensor(X))), np.asarray(jax_linalg.hermitian_outer(X)), atol=1e-10
    )
    np.testing.assert_allclose(
        to_np(linalg.quadratic_form(torch.as_tensor(X), torch.as_tensor(U))),
        np.asarray(jax_linalg.quadratic_form(X, U)),
        atol=1e-10,
    )


@pytest.mark.parametrize("ndim", [2, 3])
def test_minimum_distortion_principle(rng, ndim):
    Y = make_mixture(rng, n_channels=2, n_bins=9, n_frames=20)
    X = make_mixture(rng, n_channels=3, n_bins=9, n_frames=20)
    reference = X[0] if ndim == 2 else X
    expected = np.asarray(jax_pkg.minimum_distortion_principle(Y, reference))
    out = minimum_distortion_principle(torch.as_tensor(Y), torch.as_tensor(reference))
    assert out.shape == expected.shape
    np.testing.assert_allclose(to_np(out), expected, atol=1e-10)
    with pytest.raises(ValueError):
        minimum_distortion_principle(torch.as_tensor(Y), torch.as_tensor(X[None]))
    assert generalized_minimum_distortion_principle() is None


def _whitening_input(rng):
    x = rng.randn(3, 200) * np.array([[1.0], [5.0], [0.2]])
    x[1] += 0.5 * x[0]
    return x


@pytest.mark.parametrize("as_tensor", [False, True])
def test_whitening(rng, as_tensor):
    """NumPy input on ``device="cpu"``, and a CPU tensor, which stays on its
    device."""
    x = _whitening_input(rng)
    out = port.whitening(torch.as_tensor(x)) if as_tensor else port.whitening(x, device="cpu")
    assert out.device.type == "cpu"
    out = to_np(out)
    expected = np.asarray(jax_pkg.whitening(x))
    sign = np.sign(np.sum(out * expected, axis=1, keepdims=True))  # eigh's sign per row
    np.testing.assert_allclose(out * sign, expected, atol=1e-10)
    np.testing.assert_allclose(out @ out.T, np.eye(3), atol=1e-10)
    with pytest.raises(AssertionError):
        port.whitening(torch.as_tensor(x), zero_mean=False)
    with pytest.raises(AssertionError):
        port.whitening(torch.as_tensor(x), channel_first=False)


def test_whitening_numpy_input_defaults_to_cuda(rng, monkeypatch):
    """NumPy input goes to the card unless the caller asks for the CPU: on a
    machine without one, the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.whitening(_whitening_input(rng))


def test_fixed_point_ica_and_stft_alias():
    ica = FixedPointICA(n_channels=4, device="cpu")
    np.testing.assert_array_equal(to_np(ica.demix_filter), JaxFixedPointICA(n_channels=4).demix_filter)
    alias = importlib.import_module("audio_source_separation_tpu_torch.algorithm.stft")
    module = importlib.import_module("audio_source_separation_tpu_torch.transform.stft")
    assert alias.stft is module.stft and alias.istft is module.istft


def test_models_export_what_jax_exports():
    """The port's ``models`` exports the JAX ``models`` names, each
    importable."""
    assert set(port_models.__all__) == set(jax_models.__all__)
    assert all(callable(getattr(port_models, name)) for name in port_models.__all__)


def test_package_exports_what_jax_exports():
    """The JAX package's top-level functions are the port's too, beside every
    name of the port's ``models``."""

    def public(module):
        return {k for k, v in vars(module).items() if not k.startswith("_") and not isinstance(v, types.ModuleType)}

    assert {"whitening", "minimum_distortion_principle"} <= public(jax_pkg)
    assert public(jax_pkg) <= public(port)
    assert set(port_models.__all__) <= public(port)

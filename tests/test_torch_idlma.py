"""The port's GaussIDLMA against the JAX package on the CPU at float64, in
both of the JAX package's modes: ``jax_dnn=True`` with a JAX MLP of the
benchmark row's form against the port's ``nn.Module`` from the same NumPy
weights, and ``jax_dnn=False`` with a NumPy oracle against its torch
counterpart.  Each case compares the whole loss trajectory (rtol 1e-9), the
final filter and the output (atol 1e-8), at C = 2 (the component form), C
= 5 and with the ``svd`` guard (the matrix form); then the callback,
the raises, the absence of a warm start and the covariance route through
K1's wrapper (FDICA and Prox: no kernel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.ops import cov_kernel, fused_ip

from _torch_port import to_np
from chip_smoke import VarianceMLP
from conftest import make_mixture

ITERATIONS = 8
N_BINS, N_FRAMES, HIDDEN = 17, 32, 8


def _weights(seed=3):
    r = np.random.RandomState(seed)
    return r.randn(HIDDEN, N_BINS) * 0.3, r.randn(N_BINS, HIDDEN) * 0.3


def _jax_mlp(W1, W2):
    W1, W2 = jnp.asarray(W1), jnp.asarray(W2)

    def mlp(amp):  # benchmarks/run_all.py's form
        h = jax.nn.relu(jnp.einsum("hf,sft->sht", W1, amp))
        return jax.nn.softplus(jnp.einsum("fh,sht->sft", W2, h)) + 1e-3

    return mlp


def _networks(mode, n_sources):
    """(JAX-side dnn, port-side dnn) for ``mode``: the MLP, or an oracle that
    returns fixed amplitudes whatever its input."""
    if mode == "mlp":
        W1, W2 = _weights()
        return _jax_mlp(W1, W2), port.torch_dnn(VarianceMLP(W1, W2))
    amplitude = np.abs(np.random.RandomState(4).randn(n_sources, N_BINS, N_FRAMES)) + 0.1
    return (lambda amp: amplitude), (lambda amp: torch.as_tensor(amplitude))


CASES = [
    ("mlp", 2, 2, "one_norm"),
    ("mlp", 1, 2, "none"),
    ("mlp", 2, 5, "one_norm"),
    ("mlp", 2, 2, "svd"),
    ("oracle", 2, 2, "one_norm"),
    ("oracle", 1, 2, "one_norm"),
    ("oracle", 2, 5, "one_norm"),
]


@pytest.mark.parametrize("mode,domain,n_channels,guard", CASES)
def test_matches_jax_trajectory(rng, mode, domain, n_channels, guard):
    X = make_mixture(rng, n_channels=n_channels, n_bins=N_BINS, n_frames=N_FRAMES)
    jax_dnn, torch_net = _networks(mode, n_channels)
    ref = jax_models.GaussIDLMA(domain=domain, guard=guard, jax_dnn=mode == "mlp")
    Y_ref = np.asarray(ref(X, iteration=ITERATIONS, dnn=jax_dnn))
    ours = port.GaussIDLMA(domain=domain, guard=guard, device="cpu")
    Y = ours(X, iteration=ITERATIONS, dnn=torch_net)
    assert len(ours.loss) == ITERATIONS + 1
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(to_np(ours.demix_filter), np.asarray(ref.demix_filter), atol=1e-8)
    np.testing.assert_allclose(to_np(ours.dnn_output), np.asarray(ref.dnn_output), rtol=1e-9)
    np.testing.assert_allclose(to_np(Y), Y_ref, atol=1e-8)


def test_module_and_float32_module(rng):
    """A module passed as it is runs like ``torch_dnn(module)``; a float32
    module through ``torch_dnn`` runs on a float64 solver at float32."""
    X = make_mixture(rng, n_channels=2, n_bins=N_BINS, n_frames=N_FRAMES)
    W1, W2 = _weights()
    wrapped = port.GaussIDLMA(device="cpu")
    Y = wrapped(X, iteration=3, dnn=port.torch_dnn(VarianceMLP(W1, W2)))
    bare = port.GaussIDLMA(device="cpu")
    np.testing.assert_allclose(to_np(bare(X, iteration=3, dnn=VarianceMLP(W1, W2))), to_np(Y), atol=1e-12)
    single = port.GaussIDLMA(device="cpu")
    Y32 = single(X, iteration=3, dnn=port.torch_dnn(VarianceMLP(W1.astype(np.float32), W2.astype(np.float32))))
    assert Y32.dtype == torch.complex128
    np.testing.assert_allclose(single.loss, wrapped.loss, rtol=1e-4)


def test_callback_after_each_iteration(rng):
    X = make_mixture(rng, n_channels=2, n_bins=N_BINS, n_frames=N_FRAMES)
    jax_dnn, torch_net = _networks("oracle", 2)
    seen, seen_ref = [], []
    ours = port.GaussIDLMA(callback=lambda s: seen.append(to_np(s.estimation)), device="cpu")
    ours(X, iteration=3, dnn=torch_net)
    ref = jax_models.GaussIDLMA(callback=lambda s: seen_ref.append(np.asarray(s.estimation)))
    ref(X, iteration=3, dnn=jax_dnn)
    assert len(seen) == len(seen_ref) == 3
    for a, b in zip(seen, seen_ref):
        np.testing.assert_allclose(a, b, atol=1e-9)
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)


def test_keywords_are_attributes_not_state(rng, tmp_path):
    """As in the JAX package, IDLMA starts from the identity every call: a
    passed ``demix_filter`` is an attribute and changes nothing."""
    X = make_mixture(rng, n_channels=2, n_bins=N_BINS, n_frames=N_FRAMES)
    _, torch_net = _networks("oracle", 2)
    solver = port.GaussIDLMA(device="cpu")
    Y = solver(X, iteration=3, dnn=torch_net, label="run")
    assert solver.label == "run"
    solver.save_state(tmp_path / "idlma.npz")
    assert set(solver.load_state(tmp_path / "idlma.npz")) == {"demix_filter", "estimation", "dnn_output"}
    again = port.GaussIDLMA(device="cpu")
    Y2 = again(X, iteration=3, dnn=torch_net, **solver.load_state(tmp_path / "idlma.npz"))
    np.testing.assert_allclose(to_np(Y2), to_np(Y), atol=1e-12)
    assert again.loss == solver.loss


@pytest.mark.parametrize(
    "kwargs,error",
    [({"normalize": "power"}, ValueError), ({"normalize": False}, ValueError), ({"domain": 3}, AssertionError)],
)
def test_raises(rng, kwargs, error):
    X = make_mixture(rng, n_channels=2, n_bins=5, n_frames=8)
    with pytest.raises(error):
        port.GaussIDLMA(device="cpu", **kwargs)(X, iteration=1, dnn=lambda amp: amp)


def _route_cases():
    mlp = port.torch_dnn(VarianceMLP(*_weights()))
    return {
        "idlma-c2": (lambda: port.GaussIDLMA(device="cpu"), {"dnn": mlp}, 2),
        "idlma-c5": (lambda: port.GaussIDLMA(device="cpu"), {"dnn": mlp}, 5),
        "fdica": (lambda: port.NaturalGradLaplaceFDICA(device="cpu"), {}, 3),
        "grad-fdica-c5": (lambda: port.GradLaplaceFDICA(device="cpu"), {}, 5),
        "prox": (lambda: port.ProxLaplaceIVA(device="cpu"), {}, 2),
    }


@pytest.mark.parametrize("case", ["idlma-c2", "idlma-c5", "fdica", "grad-fdica-c5", "prox"])
def test_kernel_route(rng, monkeypatch, case):
    """IDLMA forms its covariance by one call of K1's wrapper per iteration,
    per-bin ``(S, F, T)`` weights, contiguous; FDICA and Prox reach neither
    kernel's wrapper."""
    make, call, n_channels = _route_cases()[case]
    X = make_mixture(rng, n_channels=n_channels, n_bins=N_BINS, n_frames=N_FRAMES)
    shapes = []
    wrapper = cov_kernel.weighted_covariance_planes

    def counted(X, weights):
        assert weights.is_contiguous() and weights.dtype == X.real.dtype
        shapes.append(tuple(weights.shape))
        return wrapper(X, weights)

    def forbidden(*args, **kwargs):
        raise AssertionError("a kernel's wrapper was reached")

    for module in ("models.iva", "models.ilrma", "ops.covariance", "ops.cov_kernel"):
        monkeypatch.setattr("audio_source_separation_tpu_torch.{}.weighted_covariance_planes".format(module), counted)
    monkeypatch.setattr("audio_source_separation_tpu_torch.models.iva.fused_auxiva_ip_iter", forbidden)
    monkeypatch.setattr(fused_ip, "fused_auxiva_ip_iter", forbidden)
    make()(X, iteration=4, **call)
    expected = [(n_channels, N_BINS, N_FRAMES)] * 4 if case.startswith("idlma") else []
    assert shapes == expected
